#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on one CUDA card.

    python3 chip_smoke.py            # the full check, as documented below
    python3 chip_smoke.py --rays 1024 --hw 64 --frames 2   # a quicker run

Phases, one line each (any failed check raises; the exit code is then
non-zero and no result line is printed):

1. device name, CUDA version and ``nvidia-smi`` name/power limit; build
   the CUDA kernels from ``idealnerf_tpu_torch/kernels/csrc`` (timed).
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: ``--rays`` rays of a 450x450 frame through the
   paper head model (D=8, W=256, 64 coarse + 128 importance samples).
   rgb / acc / weights / last_weight are held to 3e-2 absolute, and rgb
   also to a correlation above 0.999 (the bf16 rounding points can round
   one ulp apart); the coarse kernel's fine depths are held to 2e-6 against the
   plain inverse CDF + sort run on the kernel's own coarse weights. A
   softplus-density field, a ragged ray count (1001) and the 16+16
   sampling (a power-of-two union) are checked too. Both kernels run their
   field MLP on the wgmma chain: their ptxas lines, the HGMMA
   instructions in their SASS (``cuobjdump -sass``) and each case's launch
   plan (rays per block, shared memory, weight ring) are printed. Both are
   timed at ``--rays`` and on the 202,500 rays of a whole 450x450 frame,
   the launch shape of the render path, beside a yardstick the port never
   calls: the same points' MLP as bf16 ``torch.addmm`` calls (their
   ``library_ms``), with the host time of each timed call and the
   profiled device time of one; at both sizes the last timed launch is
   held bitwise against the first and, at the tolerances above, against
   the plain version, which is timed too.
3. the slice: ``idealnerf_tpu_torch.cli.render_val.main`` renders
   ``--frames`` synthetic frames of ``--hw``² on the card. The frames must
   be finite (a non-finite pixel makes the PSNR non-finite) and each
   kernel's launch counter must equal the number of frames.
4. a small frame rendered on the card and by the plain versions on the
   host must agree (3e-2, correlation > 0.999).
5. torch.profiler over one 450x450 frame: wall and device-busy time and
   the kernels by device time (full table in chiprun_out/).
6. the fused point MLP (K4, on the wgmma chain like K1-K3, as is K5):
   both point kernels' ptxas lines and the HGMMA instructions in their
   SASS; K4 against its plain version at the training step's coarse and
   fine passes (131,072 and 393,216 points), at ``--points`` (both passes,
   524,288), at a ragged 1,001 and at one point: 3e-2 absolute and a
   correlation above 0.999 per output lane (one point: the bound alone).
   Each case's launch plan (``fused_mlp.point_launch_config``: tiles per
   block, blocks, shared memory, ring) is printed, and two launches and a
   second plan (half the tiles per block, ring 3) must be bitwise equal.
   Timed at ``--points`` through ``fused_point_mlp``, which packs the net
   on every call (the ``kernels`` line's ``ms``, as K1/K2's in phase 2),
   with the host ms of each timed call, beside its plain version
   (``plain_ms``); the last timed launch is held bitwise against the first
   and, at the tolerances above, against the plain version. Then through
   ``point_mlp`` on a packed net (weight stream + launch) with its host ms
   and the profiled device time of one call, and a yardstick the port
   never calls: the same points' MLP as bf16 ``torch.addmm`` calls with
   the dir-PE product per point (``library_ms``).
7. the gradient kernel, f32 and bf16 variants, through the training
   autograd Function against its plain version (explicit backward in
   torch ops) and against f32 autograd of the plain MLP (TF32 off), per
   parameter: the f32 variant within 1e-4 norm-relative of both; the bf16
   variant within 2e-2 of its plain version and 0.15 of f32 autograd (the
   JAX package's bound). aud/expr/latent gradients within 0.05 of their
   maximum. Two launches must give bitwise-equal gradients. Timed at
   ``--points``; the bf16 checks run again at the step's fine pass,
   393,216 points. The bf16 backward is two kernels: at both sizes and at
   a ragged 1,001, pass A (the recompute and the d_h chain, on the wgmma
   chain) alone is held against its plain version and the same
   computation in f64: every operand plane, unswizzled, no farther from
   f64 (norm-relative) than twice the plain version's own distance (at
   least 1e-3) and with a correlation above 0.999 against the plain
   version (relu' flips rule out an absolute bound on the d_h planes,
   even for the plain version against f64), the bias rows 2e-2
   norm-relative, two launches bitwise equal;
   at both sizes pass B alone is held against its plain version on pass
   A's own buffers (1e-4 norm-relative per gradient), each pass is timed
   apart, a torch.bmm of the trunk's seven H^T @ dc products is timed as
   a yardstick (the port never calls it), and the peak memory of one call
   is read. The kernels' ptxas lines are printed again; pass A may not
   spill, and its SASS must hold HGMMA (wgmma) and no HMMA (wmma). The f32
   backward is two kernels too (``k_grad_pass_a_f32``,
   ``k_grad_pass_b_f32`` behind the same wrappers: f32 FFMAs, no tensor
   core): their SASS may hold no HMMA or HGMMA (no
   TF32 product) and pass A f32 may not spill; at ``--points`` and at a
   ragged 1,001 pass A f32 alone is held against its plain version and
   f64 (every plane and the bias rows no farther from f64 than twice the
   plain version's own distance, at least 1e-5; two launches bitwise
   equal), pass B f32 alone against its plain version on pass A's
   buffers (1e-4), each pass is timed with its bound (the planes' bytes
   counted), f32 autograd of the plain MLP (cuBLAS, TF32 off) is timed as
   the yardstick, and the peak memory of one call is read.
8. the training slice: ``idealnerf_tpu_torch.cli.train_head.main`` on
   ``--train_frames`` synthetic frames of ``--train_hw``² at full width
   (D=8, W=256, N_rand 2048, 64+128) for ``--train_epochs`` epochs: first
   and last loss and PSNR (finite), both kernels launched twice per step;
   the checkpoint it writes then renders one frame through
   ``render_val.main --head_ckpt`` with a finite PSNR. Then, on a fresh
   trainer, the ms per step over whole wall windows (``_step_ms``: the
   median of 3 windows of 18 steps after 2 of warm-up) and torch.profiler
   over one training step (table in chiprun_out/).
9. the temporal delta kernel against its plain version (depth placement,
   fine pass, next band) on the phase-2 rays and a ragged 1,001 at the
   serving default s_delta 16 (3 uniform + 12 importance depths + the
   plate pin): the previous frame's (z, w) first from a real coarse +
   fine keyframe (192 wide), then from the kernel's own output (16 wide);
   also a softplus field and s_delta 17 (a union of 16 depths). Depths are
   held to 2e-6 against the plain placement, the render to 3e-2 and rgb
   correlation > 0.999, the band to 2e-6 against the plain band of the
   kernel's own depths and weights; two launches must be bitwise equal.
   The wgmma kernel's ptxas line and each case's launch (rays per group,
   shared memory, weight ring) are printed. Timed at ``--rays`` and at the
   129,024 prior rays of a 450x450 frame, beside a yardstick the port
   never calls: the same points' MLP as bf16 ``torch.addmm`` calls (K3's
   ``library_ms``); at both sizes the last timed launch is held bitwise
   against the first and, at the tolerances above, against the plain
   version.
10. the serving slice: ``idealnerf_tpu_torch.cli.serve.main`` streams
   ``--serve_frames`` synthetic frames of 450² at full width under the
   serving defaults (refresh 25, s_delta 16, prior on, AudioAttNet
   smoothing). Past its warm-up (keyframe, then two delta frames) the
   coarse and fine kernels must launch once per keyframe and the delta
   kernel once per delta frame, and every frame must be finite. Then
   ``--roll_k 4 --max_frames 10``: after frame 0 all three launch once per
   frame. A delta frame at the keyframe's own pose (rotated, off-centre
   principal point, s_delta 32) must stay above 20 dB PSNR against the
   keyframe. Then torch.profiler over one steady delta frame.
11. the kernel-diagnosis path: the encoded-input point MLP (K5,
   ``fused_point_mlp(fuse_pe=False)``) against its plain version at
   ``--points`` and a ragged 1,001 (3e-2, correlation > 0.999 per lane),
   timed beside K4 on the same points; the probes on the wgmma chain
   (the bf16 ``k_chain_wg`` in all its modes and plans, the ladder's
   rungs v0-v2 on K5's chain, probes A and B on K1's chain without
   compositing): their ptxas lines (a spill fails), HGMMA counts (none
   fails) and launch plans; every probe kernel of ``kernels/kdiag.py``
   against its plain version at a ragged 1,001 rows (the bf16 chain in
   every mode at 64 and 128 rows per block and depth 2, 8 and 16; the
   ladder's rungs; probes A and B at S 64 and 192); then each
   ``idealnerf_tpu_torch.scripts.kdiag*`` entry point at its own size
   with ``--check`` (chains at 2^21 rows, kdiag4/5 at 1M and 4M
   rows for the slope, both rows-per-block; the ladder and K5 at 2^21
   points; kdiag3 at the phase-2 rays with S 64 and 192), with the launch
   counters set to 0 before each and read after: every timed output is
   held against its plain version on the same inputs, which is timed
   once (bf16 chains within 3e-2 of the output's max abs, the f32 chain
   within 1e-5 of it, both with a correlation above 0.999; int8 chains
   bitwise equal; the ladder, K5 and the render probes 3e-2 absolute and
   correlation > 0.999, per lane for raw outputs). The library chains
   (``torch.matmul`` in bf16 and in f32 with TF32 off, ``torch._int_mm``)
   are timed by the same entry points. Last,
   ``idealnerf_tpu_torch.scripts.kframe`` times the coarse and fine
   kernels on a whole 450x450 frame through their wrappers and
   alone at other launch plans and on one wave of blocks over all and
   half the SMs: every plan's outputs must be bitwise equal to the
   wrapper's and each worker's launch counters equal to its wrapper calls.
   Then ``idealnerf_tpu_torch.scripts.kpoint`` likewise for K4 at 524,288
   points and K5 at 2^21 (ring depths, tiles per block). K5's
   ``library_ms`` is the torch.addmm yardstick on kdiag2's own encodings,
   the ladder's (rung v2) the same calls without the heads. The probes'
   entries in the ``kernels`` line name the body they run (``body``):
   the bf16 chains at 128 rows per block, the f32 chain (V3, FFMAs on a
   ring of f32 K-slabs, 128 rows per block, its one plan) an entry of its
   own at 1M rows and the int8 chain (I0 on s8 wgmma) at 1M rows and 64
   rows per block; each entry's ``launches`` counts its wrapper's launches
   at every plan and size of the run. The f32 and int8 chains' ptxas
   lines (a spill fails) and SASS are checked: the int8 chain holds IGMMA
   (s8 wgmma) and no IMMA, the f32 chain FFMA and no HMMA or HGMMA; no
   kernel of the build may have its wgmma serialized by ptxas (warning
   C7511), and probe B's warpgroup synchronisations are counted; each
   plan of the two is held against ``kdiag.chain_plan``.
12. the head + torso composite. 12a: a seeded torso field at full width
   (D=8, W=256, dim_aud 32 + 42, no expr or latent) through K2 and K1 at
   ``--rays`` and on a whole 450x450 frame cast from the first frame's
   pose, against the plain versions (rgb, acc, last_weight 3e-2 with rgb
   correlation > 0.999; the fine depths 2e-6); a 24x24 composite frame on
   the card against the plain versions on the host (3e-2, correlation >
   0.999); the composite 450x450 frame's ms beside the head frame's.
   12b: one torso step with ``train_fused 2`` against ``train_fused 0``
   on the same coords (bounds in ``_phase_torso_train``), then
   ``idealnerf_tpu_torch.cli.train_torso.main`` on phase 8's checkpoint
   for ``--train_epochs`` x ``--train_frames`` steps of N_rand 2048 on
   com frames of ``--train_hw``²: finite loss and PSNR, K4 launched 4
   times a step (two fields, the head without gradient) and the gradient
   kernel twice (the torso only), the head bitwise unchanged, a
   checkpoint at the last step; ms per step over whole wall windows
   (``_step_ms``, as phase 8's) and a profiled step. 12c:
   ``cli.eval_reenact.main --torso_ckpt`` renders ``--frames`` composite
   frames of ``--hw``²: finite, K2 and K1 launched twice a frame. 12d
   (ROADMAP.md B10): the paper model (D=8, 64+128) at W=128 and W=512 on
   the kernels' own instances of those widths: K1-K3 at 8,192 rays of a
   450x450 frame, K4, K5 and K6 (bf16 and f32, repeated bitwise) at
   524,288 points against their plain versions and timed beside them
   with their bounds (each kernel's ``widths`` in the kernels line); a
   head trained by ``train_head.main`` on the card (K4 and K6 twice a
   step) and ``render_val.main`` of its checkpoint (K2 and K1 once a
   frame) at 450x450, and at 32x32 on the card and on the host, agreeing
   within 3e-2, correlation > 0.999; a W=1024 net is refused by both
   entry points before any launch, naming B10 (``--only_widths`` runs
   the build and this phase alone). 12e (run before 12d), the temporal composite from phase 8's
   head and 12b's torso on the 450x450 subject of phases 9-10 (its
   per-field priors: the head's and the torso's rays): K3 on the torso
   field (the torso prior's rays cast from the first pose, the torso
   net) against its plain version at s_delta 16 and 32, with phase 9's
   checks, and K1 on a freeze_z torso delta frame (all torso rays, then
   the kept rays of delta_keep 0.01, on the keyframe's own depth grid)
   with phase 2's; ``cli.serve.main --head_ckpt --torso_ckpt`` at the
   serving defaults for ``--serve_frames`` frames, then ``--roll_k 4
   --max_frames 10``, past the warm-up K2 and K1 twice a keyframe and K3
   twice a delta frame (rolling: all three twice a frame after the
   first); ``cli.eval_reenact.main --torso_ckpt --temporal 5 --prior 1``
   over 10 frames with ``--cycle 1``, ``--cycle 0`` (frames bitwise equal
   to ``--cycle 1``'s; both run the per-frame loop), ``--freeze_z_torso 1
   --delta_keep_torso 0.01`` (the torso's delta frames launch K1, not K3)
   and ``--roll_k_torso 4`` (no torso K3, K2 + K1 on the torso slice every
   delta frame), each mode's launches asserted and its frame_ms printed;
   ``render.cycle`` over two delta frames of a pruned, kf_blend cache, its
   frames and cache bitwise those of per-frame calls; last, a run without
   ``--prior`` whose keyframe is phase 12c's composite frame of the same
   pose and conditioning within 2e-5.
13. the real-subject path. 13a: the JPEG route (Pillow) and its libjpeg
   version; an 8-frame 450x450 synthetic subject with torso written
   through ``data.export.write_reference_format`` and read back by
   ``data.dataset.load_transforms_dataset``: poses and exprs within 1e-5,
   landmarks within 0.01, audio equal, the split sizes, images within a
   mean abs error of 6 levels; the decode ms per frame, the subject's
   load time and the .avi write ms per frame. 13b:
   ``cli.train_head.main --config <subject>/HeadNeRF_config.txt`` (its
   datadir, near and far) at the paper model, 2 epochs of N_rand 2048:
   K4 and K6 twice a step, ``metrics.jsonl`` one finite record per
   ``--i_print`` with the JAX CLI's keys. 13c: ``cli.train_torso.main``
   on the subject's com_imgs, 5 steps: K4 4 and K6 2 a step, ``torso/``
   records. 13d: ``cli.render_val.main --head_ckpt`` writes
   ``subject_head_val.avi`` and its still; its frames read back from the
   file are within JPEG error (mean abs error under 6 levels) of the
   frames ``main`` returns; K2/K1 once a frame. 13e:
   ``cli.eval_reenact.main --torso_ckpt`` (3 frames, K2/K1 twice a frame)
   and ``cli.serve.main`` (the subject's 8 audio windows, launches as
   phase 10's) each write their .avi with the right frame count. 13f: the
   paper model drawn from ``tests/fixtures/jax_frame_450.json``'s seed
   (``bridge.seeded_tree``) renders the synthetic subject's frame 0
   through K2 + K1 (one launch each) within 3e-2 and correlation > 0.999
   of the JAX package's plain XLA frame committed as
   ``tests/fixtures/jax_frame_450.png``.
14. the per-frame fast modes and the depth-band probes at the paper
   width, from phase 8's head and phase 12b's torso on their 450x450
   subject (``_phase_fast``). 14c (run first: 14b takes its bands):
   ``eval.renderer.subject_depth_range`` and ``torso_depth_range`` (the
   plain f32 frame at 64+128) with their seconds, ``cached_depth_band``
   and ``cached_occupancy_prior`` read back without a probe,
   ``field_occupancy_prior`` over two probe frames, and K2 then K1 on a
   ragged count of the occupancy prior's rays (a last ray group part
   full in both) against their plain versions. 14a:
   ``make_pruned_frame_renderer`` at keep 0.4 and 1.0, prior-masked, and
   prior-masked with the occupancy cut: K1 twice a frame and K2 never;
   each frame against the same path on the plain versions (the wrappers
   eval/renderer.py imports swapped, ``_plain_kernels``; 3e-2, corr >
   0.999), keep 1.0 also against the full-fidelity K2 + K1 frame (to
   the same bar on all but the 4 rays JAX's budget rounding leaves
   coarse at 450x450, 202,496 of 202,500), the others measured against
   it (max abs error, PSNR); ms per frame by CUDA events beside the full
   frame's; all on the checkpoint head and on a seeded one (phase 4's
   seed: mass on every ray, where 20 training steps may have emptied
   the checkpoint's coarse net). 14b:
   ``make_composite_fast_renderer`` with per-field priors and the 14c
   bounds, and at keep 1.0 against ``make_composite_frame_renderer`` (all
   but 4 coarse-only rays a field): K2 and K1 twice a frame, on both
   pairs. 14d: on phase 13's subject directory,
   ``render_val --pruned 40 --prior_masked 1 --occ_prior 1
   --tighten_bounds 1`` (K1 2 a frame), ``eval_reenact --fast 40 --prior
   1`` head-only (K1 2) and with ``--torso_ckpt`` (K2 2, K1 2), and
   ``eval_reenact --tighten_bounds 1`` (K2 1, K1 1; its band read from
   the depth_bands.json render_val wrote): each .avi holds the frames
   returned, each run prints its ``frame_ms``.
15. the quality-gate harness and the gated operating points
   (``_phase_gates``). 15a: ``scripts.rehearsal`` writes a 450x450
   with-torso subject of 48 frames (24 val) and trains its head (1,512
   steps at the rehearsal's paper config) and torso (500 steps) through
   the CLIs: K4 2 and K6 2 a head step, K4 4 and K6 2 a torso step. 15b:
   ``scripts.sample_sweep`` over 64+128, 32+64 and 16+32 (K2 and K1 once
   a val frame and rung). 15c: ``scripts.temporal_delta --refresh 8
   --frames 20 --s_delta 32 16 --tighten --auto_rung``: the composite and
   head-only clips at full fidelity and in each temporal mode, K2/K1 on
   every keyframe and K3 on every delta frame of each field, every K3
   call at a measured s_delta; its rows, PSNRs and the fit of the delta
   frame's cost are printed. 15d: ``gated_video_config`` for the head and
   the composite prints which gates open and by what margin; where one
   opens, ``serve --auto_temporal`` and ``eval_reenact --auto_temporal``
   run at its point (keyframes at its refresh, every K3 call at its
   s_delta on its kept rays, launches counted past the stream's
   warm-up); where one is closed, both CLIs refuse with exit code 2 and
   launch nothing; ``serve --auto_temporal --roll_k 4``, a cadence with
   no evidence, is refused. At least one gate must open on the evidence
   the harness measured.
16. the exact-f32 training path (``train_fused`` 1, ``_phase_train_f32``):
   ``cli.train_head.main --train_fused 1`` for ``--train_epochs`` epochs on
   ``--train_frames`` synthetic frames of ``--train_hw``² at full width
   (N_rand 2048, 64+128): finite loss, K4 2 and the f32 passes 2 a step,
   the bf16 passes none; then on fresh trainers at ``train_fused`` 1 and
   2 the ms per step (``_step_ms``) and a profiled step's idle share. One
   head step (on phase 8's checkpoint) and one torso step at
   ``train_fused`` 1 on fixed coordinates (no draws): the same step with
   the backward swapped for f32 autograd of the plain MLP at the step's
   own cotangent gives a bitwise-equal loss and every parameter gradient
   within GRAD_TOL["f32"]["autograd"]; against ``train_fused`` 0, whose
   forward is f32 where K4's is bf16 at ``train_fused`` 1 and 2, the
   loss and gradients are held to phase 12b's bounds.

17. the measurement scripts (``_phase_measure``), each one's ``main`` on
   the card with its JSON printed on a line of its own and every number
   in it finite: ``train_profile`` (the step bisection at N_rand 3072,
   64+128; K4 and K6 twice a step in each variant), ``stream_latency``
   over phase 15's subject at its comp and head gates, 240 pushes (K3
   once per live field and delta frame; a closed gate returns 1 and
   launches nothing), ``temporal_profile`` and ``comp_profile`` at 450²
   (the stages run in order give the whole frame within 1e-6),
   ``composite_delta`` on phase 15's pair (its full clip bitwise
   ``make_composite_frame_renderer``'s, called as phase 12 calls it) and ``audatt_peak`` on phase 8's checkpoint; their launches count in
   the kernels line.
18. the model variants and the second-stage, baseline and UNet trainers
   (``_phase_variants``) at the paper's widths (D=8, W=256, dim_aud 64,
   dim_expr 76, dim_latent 32, dim_agg 64, attn_output_ch 256, 64+128).
   18a, for ``face_nerf_agg`` and ``attention_nerf`` with softplus
   density (a 20-step relu run can empty a net): ``cli.train_head
   --model_variant`` for ``--train_epochs`` x ``--train_frames`` steps at
   N_rand 2048 (K4 and K6 twice a step); one step on seeded weights at
   ``train_fused`` 2 against 0 on fixed coordinates, no draws, at phase
   12b's bounds for the loss and every gradient, the extras' among them
   (a zero gradient fails, but for q and k of the one-row attention,
   which must be zero on both paths); ``cli.render_val`` of one 450²
   frame from the checkpoint against the same call with K1 and K2
   replaced by their plain versions wherever they are looked up (3e-2,
   correlation > 0.999; K2 and K1 once, none in the plain call; 1 % of
   the pixels off the plate); ``cli.serve`` over 10 frames (launches
   past the warm-up as phase 10's). 18b: ``cli.train_baseline`` for as
   many steps (K4, K6 twice a step). 18c: the second stage with a second
   synthetic subject's audio (``--driving_aud``): one crop-96 loss on
   seeded weights with softplus density (two tiles of 8,192 rays, the
   second padded) at ``train_fused`` 2 against 0 at phase 12b's bounds,
   every gradient live; from phase 8's checkpoint
   ``cli.train_second_stage`` at crop 256 for 5 steps at ``train_fused``
   2 and 2 at 1 (8 tiles a step; K4 four times a tile, its forward run
   again in the checkpointed backward, K6 twice), each step's ms and the
   run's peak memory, a profiled step's idle share; ``--aux_landmark 1
   --steps 2`` trains in a process of its own (a finite aux loss above
   zero each step, a checkpoint). 18d: ``train.unet.UNetTrainer`` for 5 steps
   at 450² (the UNet through cuDNN, TF32 off), finite losses, and its
   feature map held against the host's on the same weights.
19. the second stage's aux losses (``_phase_aux``, ROADMAP A11). 19a: FAN
   at the paper's size (4 stacks, a 256² crop, 64² heatmaps), VGG16 through
   relu5_3 and VGGFace on seeded weights at 256², each the same module on
   the card (cuDNN, TF32 off) and on the host (FAN atol 2e-3 + rtol 1e-3,
   the VGG taps atol 2e-5 + rtol 2e-4: the CPU tests'), and the landmark
   loss (1e-5 relative) and its gradient with respect to the crop at the
   host's heatmap-difference signs (the flipped ones counted) against the
   host's float64 one: within 1e-4 norm-relative or twice the host's f32
   distance from it. 19b: ``cli.train_second_stage`` at crop 256 from phase
   8's head on 18c's driving audio with ``--aux_landmark``, ``--aux_vgg``
   and ``--aux_vggface`` on (``AUX_WEIGHTS``), 3 steps at ``train_fused`` 2
   and 1 at 1: finite losses, aux losses above zero, K4 four and K6 two
   launches a tile and no other kernel, a checkpoint; ms per step and peak
   memory beside 18c's, and a profiled step's busy time split into the
   convolutions and K4 + K6 beside 18c's. 19c: ``scripts.train_fan_proxy``
   on phase 15's subject (crop 256, 60 steps; the landmark error before and
   after, which must fall), then ``scripts.rehearsal_2nd`` for 3 steps with that proxy as
   ``--fan_npz`` (K4 and K6 per tile).
20. the offline pipeline (``_phase_pipeline``, ROADMAP A12). 20a: a
   synthetic subject of 32 frames of 450² and 3 s of audio, random
   full-width weights from the port's init functions (FAN 4 stacks as a
   .pth, BiSeNet at ResNet18 widths as an .npz, DeepSpeech at 2048 hidden
   units as a frozen graph, the reference-scale BFM stand-in as
   ``--bfm``), through ``python -m idealnerf_tpu_torch.cli.process_data``
   in a process of its own on its default device: each step's wall time
   and the peak memory, every file it must write checked, then
   ``train_head`` on its train split (K4, K6 twice a step) and
   ``render_val`` of one val frame (K2, K1 once) from it; whether the
   machine has ``ffmpeg``. 20b: card against host, TF32 off: BiSeNet's
   three heads at 512² (atol 2e-3, rtol 1e-3), DeepSpeech's logits at 2048
   hidden units (rtol 2e-4, atol 2e-5), one ``rasterize_soft`` image and
   its vertex gradient at 96² (card, host and the host's float64 run
   pairwise within colour 5e-3 on the 0-255 scale, alpha 1e-5, gradient
   3e-4 norm-relative), ``FaceTracker._photometric_initial`` for 52 steps
   at 48² (id, exp, euler and trans within 5e-4, texture and light 1.5e-2;
   its loss at steps 50 and 51 within 1e-5 relative),
   the landmark stages' final loss at a fifth of their default steps
   (1e-4 relative, the same focal); profiles of the BiSeNet and DeepSpeech forwards and of
   50 landmark-fit steps. 20c: ``scripts.track_bench`` at 450² on the
   34,500-vertex, 68,242-triangle stand-in, overflow 0.
21. multi-device (ROADMAP A13) on the one card, each rank a process of
   ``parallel.launch``. 21a: one rank through NCCL (a 1 x 1 mesh): three
   sharded head steps against ``HeadTrainer``'s from the same seed at
   450², N_rand 2048 (parameters within 1e-6), both timed. 21b: two ranks
   on cuda:0 through gloo (NCCL refuses two ranks on one card), spawned
   once: the head and the torso gradients of a 1 x 2 and a 2 x 1 step,
   the crop-256 second stage's with the three aux terms (1 x 2), each
   within 1e-3 norm-relative per tensor of one device's on the same
   draws, and the ray-sharded 450² frame and composite within 1e-6 of one
   device's; the 1 x 2 and 2 x 1 steps and the 1 x 2 frame timed beside
   one device's (rank 0 alone), with the card's idle share (the ranks'
   busy ms over rank 0's wall). 21c: ``train_head --ray_devices 2`` (4
   steps at 450²) and ``render_val --ray_devices 2`` from their entry
   points, the frames within 1e-6 of phase 3's. Each rank's backend and
   device are asserted, and K1, K2, K4 and K6 must launch on the mesh's
   paths (the ranks' own counts, the one-device references beside them
   not counted).

Then the kernel summary as one JSON line (each kernel's launches on its
paths, K1/K2 over render_val, the composite reenact and phase 14's fast
frames and CLIs, K4/K6 over train_head and train_torso, K3 over the
head-only and the composite serve, each also on the subject directory of
phase 13, and all five over phase 15's training, sweep, harness and
``--auto_temporal`` runs, K4/K6 also over phases 18 and 19's trainers and
K1/K2/K4/K6 over phase 20's train_head and val frame and over phase
21's mesh paths; the
f32 backward's two kernels over phase 16's ``train_head --train_fused 1``
and the second stage's; its max error, its time and its plain version's,
and its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations at the H100 SXM data sheet's dense rate for their type, 989
TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s f32:
``idealnerf_tpu_torch.scripts.PEAK``), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. With no
CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ATOL = 3e-2
MIN_CORR = 0.999
Z_ATOL = 2e-6
GRAD_TOL = {"f32": {"plain": 1e-4, "autograd": 1e-4},
            "bf16": {"plain": 2e-2, "autograd": 0.15}}
COND_TOL = 0.05
PASS_A_TOL = 2e-2
PASS_A_FLOOR = 1e-3
PASS_A_F32_FLOOR = 1e-5  # the f32 emulation test's (test_torch_grad_f32.py)
PASS_B_TOL = 1e-4
FINE_POINTS = 2048 * 192  # the training step's fine pass
STEP_POINTS = (2048 * 64, FINE_POINTS)  # its coarse and fine passes
KERNELS = {
    "fused_render_coarse_hier": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:499",
    },
    "fused_render_rays": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:393",
    },
    "fused_point_mlp": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_mlp.py:289",
    },
    "fused_point_mlp_grad": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp_grad.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_mlp_grad.py:178",
    },
    "grad_pass_a_f32": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp_grad.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_mlp_grad.py:178",
    },
    "grad_pass_b_f32": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp_grad.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_mlp_grad.py:178",
    },
    "fused_render_delta": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:604",
    },
    "fused_point_mlp_pe": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp.cuh",
        "replaces": "idealnerf_tpu/kernels/fused_mlp.py:311",
    },
    "kdiag_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag.py:70",
    },
    "kdiag2_ladder": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag_pe.cu",
        "replaces": "scripts/kdiag2.py:114",
    },
    "kdiag3_render_a": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag_pe.cu",
        "replaces": "scripts/kdiag3.py:269",
    },
    "kdiag3_render_b": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag3.py:291",
    },
    "kdiag3_render_c": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cuh",
        "replaces": "scripts/kdiag3.py:315",
    },
    "kdiag4_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag4.py:90",
    },
    "kdiag4_chain_f32": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag_dtype.cu",
        "replaces": "scripts/kdiag4.py:90",
    },
    "kdiag5_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag_dtype.cu",
        "replaces": "scripts/kdiag5.py:114",
    },
}
HBM_BYTES_S = 3.35e12
# launches of stream.warmup(): keyframe -> first delta -> steady delta, and
# with --roll_k: keyframe -> two rolling frames
WARMUP = {"fused_render_coarse_hier": 1, "fused_render_rays": 1,
          "fused_render_delta": 2}
WARMUP_ROLL = {"fused_render_coarse_hier": 3, "fused_render_rays": 3,
               "fused_render_delta": 2}
# the composite stream runs two fields: each frame's launches twice
WARMUP_COMP = {k: 2 * n for k, n in WARMUP.items()}
WARMUP_COMP_ROLL = {k: 2 * n for k, n in WARMUP_ROLL.items()}
MIN_GEOMETRY_PSNR = 20.0
PROFILE_TRIES = 3  # profiled calls before a timing counts as not measured
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            "nvidia-smi: " + out.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _agree(name, got, want, atol=ATOL, corr=False):
    """Max abs error within ``atol``; with ``corr`` also the correlation
    (rgb only: acc and last_weight are ~1 on every ray, where a
    correlation measures nothing)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    c = float("nan")
    if corr:
        c = float(torch.corrcoef(torch.stack([got.reshape(-1),
                                              want.reshape(-1)]))[0, 1])
    ok = err <= atol and (not corr or c > MIN_CORR)
    print(f"  {name}: max_abs_err {err:.3e} (tol {atol:g})"
          + (f", corr {c:.6f} (> {MIN_CORR})" if corr else ""))
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version")
    return err


def _time_ms(fn, iters: int, host=None) -> float:
    """CUDA-event ms per call of fn over ``iters`` calls after a warm-up;
    ``host`` (a list) gets the host ms each timed call takes to return."""
    import torch

    fn()                                   # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        h0 = time.perf_counter()
        fn()
        if host is not None:
            host.append(1e3 * (time.perf_counter() - h0))
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _num(x, fmt: str, unit: str = "") -> str:
    """``x`` in ``fmt`` with its unit, or "not measured" where it is None."""
    return "not measured" if x is None else format(x, fmt) + unit


def _device_ms(run, key: str) -> float:
    """Device ms of the kernels whose name holds ``key`` in one warm call
    of ``run`` (torch.profiler). The profiler's device trace comes back
    empty now and then: up to ``PROFILE_TRIES`` profiled calls are tried,
    then the CUDA-event ms of one whole call (all its kernels) stands in,
    and the line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ms = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages() if key in e.key) / 1e3
        if ms > 0:
            return ms
    print(f"  the profiler saw no device time of {key} in {PROFILE_TRIES} "
          "calls: the CUDA-event ms of one whole call stands in")
    return _time_ms(run, 1)


def _profile(run, label: str, fname: str) -> dict:
    """torch.profiler over one warm call of ``run``: device busy time and
    the kernels by device time (table in chiprun_out/), the wall of an
    unprofiled call right before it and the idle share against that wall
    (the profiler's own host time lengthens the profiled call, whose wall
    is kept as ``profiled_wall_ms``). Where ``PROFILE_TRIES`` profiled
    calls show no device time, busy time and idle share are None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device trace comes back empty now and then: profile again
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            profiled_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        # device-side events only: an aten op's own row repeats its
        # kernels' time
        on_dev = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
        if busy_ms > 0:
            break
    else:
        busy_ms = None
    top = sorted(on_dev, key=dev_us, reverse=True)[:8]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    # the port's kernels (namespace fr::) and the convolutions: the device
    # time of the aten ops' kernels, forward and backward (cuDNN)
    conv_us = sum(getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
                  for e in events if e.key in CONV_OPS)
    out = {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
           "device_busy_ms": busy_ms,
           "idle_share": (None if busy_ms is None
                          else max(0.0, 1.0 - busy_ms / wall_ms)),
           "kernels_ms": (None if busy_ms is None else sum(
               dev_us(e) for e in on_dev if "fr::" in e.key) / 1e3),
           "conv_ms": None if busy_ms is None else conv_us / 1e3,
           "top": [[e.key, dev_us(e) / 1e3, e.count] for e in top]}
    print(f"profile {label}: wall {wall_ms:.1f} ms ({profiled_ms:.1f} "
          f"profiled), device busy {_num(busy_ms, '.1f', ' ms')}, idle share "
          f"{_num(out['idle_share'], '.3f')}; the port's kernels "
          f"{_num(out['kernels_ms'], '.1f', ' ms')}, convolutions "
          f"{_num(out['conv_ms'], '.1f', ' ms')}; by device "
          "time: " + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}"
                               for k, ms, n in out["top"]))
    return out


def _mlp_macs(ncfg):
    """(multiply-adds per point, per ray) of the field: the trunk with its
    skip input, the view branch and the heads per point; the view layer's
    dir-PE part per ray (the point kernels pay it per point)."""
    W, D, V = ncfg.width, ncfg.depth, ncfg.width // 2
    pt = ncfg.input_ch * W + (D - 1) * W * W + W * V + (D // 4) * V * V
    pt += sum(ncfg.input_ch * W for i in range(1, D) if i - 1 in ncfg.skips)
    return pt + W + 3 * V, ncfg.input_ch_views * V


def _bound(flops: float, nbytes: float, kind: str = "bf16") -> dict:
    """The least time the card could take: operations at the dense peak
    for their type or bytes at the memory rate, whichever is longer."""
    from idealnerf_tpu_torch.scripts import PEAK

    t_ops, t_bytes = flops / PEAK[kind], nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _weight_bytes(ncfg) -> int:
    """bf16 weights and f32 biases, each read once."""
    pt, ray = _mlp_macs(ncfg)
    V = ncfg.width // 2
    return 2 * (pt + ray) + 4 * (ncfg.depth * ncfg.width
                                 + (1 + ncfg.depth // 4) * V + 4)


def _ray_bound(ncfg, rays: int, S: int, cols_in: int, cols_out: int):
    """Bound of a ray kernel: ``rays`` rays of S samples, reading
    ``cols_in`` and writing ``cols_out`` f32 values per ray."""
    pt, ray = _mlp_macs(ncfg)
    return _bound(2.0 * rays * (S * pt + ray),
                  _weight_bytes(ncfg) + 4.0 * rays * (cols_in + cols_out))


def _grad_macs(ncfg):
    """(pass A's, pass B's) multiply-adds per point of the rematerialising
    backward, at the real widths (no lane padding): pass A the forward and
    the d_h chain, which stops at layer 0's output and so multiplies by no
    W0^T, no skip layer's PE part^T and no wv0d^T; pass B every weight
    gradient once, as many as the forward."""
    pt, ray = _mlp_macs(ncfg)
    n_pe = 1 + sum(1 for i in range(1, ncfg.depth) if i - 1 in ncfg.skips)
    return 2 * (pt + ray) - n_pe * ncfg.input_ch * ncfg.width - ray, pt + ray


def _point_bound(ncfg, n: int, grads: bool, kind: str = "bf16",
                 plane_bytes: float = 0.0):
    """Bound of a point kernel on n points (pts, dirs in; raw out, or the
    cotangent in and f32 weight gradients out): the forward's multiply-adds,
    or the backward's (_grad_macs), at the dense peak of ``kind`` (the f32
    gradient kernels: "f32", the card's rate outside the tensor cores).
    ``plane_bytes``: the operand planes a two-pass backward writes and
    reads back, counted twice."""
    pt, ray = _mlp_macs(ncfg)
    nbytes = _weight_bytes(ncfg) + 4.0 * n * (6 + 4) + 2.0 * plane_bytes
    macs = pt + ray
    if grads:
        nbytes += 2 * _weight_bytes(ncfg)
        macs = sum(_grad_macs(ncfg))
    return _bound(2.0 * n * macs, nbytes, kind)


def _delta_split(s_delta: int):
    """(s_uni, s_imp) of a delta frame of s_delta depths, at the
    renderers' default uni_frac 0.25."""
    n_in = s_delta - 1
    s_uni = max(2, int(n_in * 0.25))
    return s_uni, n_in - s_uni


def _addmm_mlp(packed, heads: bool = True):
    """The yardsticks' MLP as bf16 torch.addmm calls, bias in the call and
    relu in place: (pe, view-layer-0 term pv) -> raw (n, HEADS), the trunk
    with the skip layer's PE product, the view branch, the heads; without
    ``heads`` the view branch's last activation (n, W/2)."""
    import torch

    bf = torch.bfloat16
    b = [x.to(bf) for x in packed.b]
    bv = [x.to(bf) for x in packed.bv]
    bh = packed.b_heads.to(bf)

    def mlp(pe, pv):
        h = torch.addmm(b[0], pe, packed.w[0]).relu_()
        for i in range(1, len(packed.w)):
            acc = b[i]
            if i in packed.wskip:
                acc = torch.addmm(acc, pe, packed.wskip[i])
            h = torch.addmm(acc, h, packed.w[i]).relu_()
        hv = torch.addmm(pv, h, packed.wv[0]).relu_()
        for v in range(1, len(packed.wv)):
            hv = torch.addmm(bv[v], hv, packed.wv[v]).relu_()
        if not heads:
            return hv
        return torch.addmm(torch.addmm(bh, h, packed.w_alpha), hv,
                           packed.w_rgb)
    return mlp


def _mlp_library_ms(fr, packed, o, d, z, chunk: int = 1 << 22) -> float:
    """The ray kernels' yardstick, timed only (the port never calls it):
    the field MLP of the R x S points of rays o, d at depths z as bf16
    torch.addmm calls (_addmm_mlp) on chunks of whole rays of at most
    ``chunk`` points, the view branch's per-ray term expanded per point.
    The encodings are made before the timing."""
    import torch
    import torch.nn.functional as F

    from idealnerf_tpu_torch.core.embedding import positional_encoding

    bf = torch.bfloat16
    S = z.shape[1]
    ped = positional_encoding(d / d.norm(dim=-1, keepdim=True),
                              packed.multires_views)
    ped = F.pad(ped, (0, fr.PED_PAD - ped.shape[1])).to(bf).float()
    pv = (ped @ packed.wv0d.float() + packed.bv[0]).to(bf)
    step = max(1, chunk // S)
    parts = []
    for s in range(0, o.shape[0], step):
        pts = (o[s:s + step, None] + d[s:s + step, None]
               * z[s:s + step, :, None]).reshape(-1, 3)
        pe = positional_encoding(pts, packed.multires)
        parts.append((F.pad(pe, (0, fr.PE_PAD - pe.shape[1])).to(bf),
                      pv[s:s + step].repeat_interleave(S, 0)))
        del pts, pe
    mlp = _addmm_mlp(packed)

    def run():
        for pe, pv in parts:
            mlp(pe, pv)

    ms = _time_ms(run, 3)
    del parts
    return ms


def _point_library_ms(packed, pe, ped, chunk: int = 1 << 22,
                      heads: bool = True) -> float:
    """The point kernels' yardstick, timed only (the port never calls it):
    the MLP of the points of the bf16 encodings pe (N, PE_PAD) and ped (N,
    PED_PAD) as bf16 torch.addmm calls (_addmm_mlp) on chunks of at most
    ``chunk`` points, view layer 0's dir-PE product per point (bv[0] +
    ped @ wv0d) one more torch.addmm. Without ``heads``: kdiag2's rung v2
    (trunk, skip, view branch), the ladder's yardstick."""
    import torch

    mlp = _addmm_mlp(packed, heads)
    bv0 = packed.bv[0].to(torch.bfloat16)

    def run():
        for s in range(0, pe.shape[0], chunk):
            mlp(pe[s:s + chunk],
                torch.addmm(bv0, ped[s:s + chunk], packed.wv0d))

    return _time_ms(run, 3)


def _hgmma_counts(so_path: str, names, op: str = "HGMMA") -> dict:
    """``op`` instructions (wgmma's HGMMA by default; HMMA for wmma and
    mma.sync) in the SASS of each kernel whose mangled name holds one of
    ``names`` (``scripts.harness.sass_counts``)."""
    from idealnerf_tpu_torch.scripts.harness import sass_counts

    return sass_counts(so_path, names, (op,))[op]


def _phase_frame(fr, nets, fc, ff, ncfg, near, far, n_s, n_i, sizes,
                 ptxas, so_path) -> dict:
    """Phase 2b: the coarse and fine kernels' ptxas lines and HGMMA
    counts, then both timed at each size of ``sizes`` (tag -> rays o, d,
    bc) beside the plain versions, the torch.addmm yardstick and the
    bound; the last timed launch is held bitwise against the first and,
    like phase 2a, against the plain version."""
    import torch

    from idealnerf_tpu_torch.core.sampling import stratified_sample

    for i, ln in enumerate(ptxas):
        if any(f"Function properties for _ZN2fr{k}" in ln
               for k in ("13k_render_rays", "13k_coarse_hier")):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
    names = ("k_coarse_hier", "k_render_rays", "k_render_delta")
    hgmma = _hgmma_counts(so_path, names)
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    if not all(hgmma[k] > 0 for k in names):
        raise AssertionError(f"a chain kernel has no HGMMA: {hgmma}")
    S = n_s + n_i
    pt, ray = _mlp_macs(ncfg)
    packed = {k: fr.pack_operands(nets[k], f, ncfg)
              for k, f in (("coarse", fc), ("fine", ff))}
    out = {"hgmma": hgmma}
    for tag, (o, d, b) in sizes.items():
        R, dev = o.shape[0], o.device
        c_args = (nets["coarse"], fc, ncfg, o, d, b, near, far, n_s, n_i)
        first_c, z = fr.fused_render_coarse_hier(*c_args)
        f_args = (nets["fine"], ff, ncfg, o, d, z, b)
        first_f = fr.fused_render_rays(*f_args)
        last = {}
        runs = {
            "coarse": lambda: last.update(
                coarse=fr.fused_render_coarse_hier(*c_args)),
            "coarse plain": lambda: last.update(
                coarse_plain=fr.fused_render_coarse_hier_reference(*c_args)),
            "fine": lambda: last.update(fine=fr.fused_render_rays(*f_args)),
            "fine plain": lambda: last.update(
                fine_plain=fr.fused_render_rays_reference(*f_args))}
        host = {k: [] for k in runs}
        ms = {k: _time_ms(fn, 2 if "plain" in k else 5, host[k])
              for k, fn in runs.items()}
        (kc, kz), (pc, _) = last["coarse"], last["coarse_plain"]
        kf, pf = last["fine"], last["fine_plain"]
        same = (all(torch.equal(first_c[k], kc[k]) for k in first_c)
                and torch.equal(z, kz)
                and all(torch.equal(first_f[k], kf[k]) for k in first_f))
        print(f"  R={R} ({tag}): the last timed launches bitwise equal to "
              f"the first: {same}; against the plain versions:")
        if not same:
            raise AssertionError("a timed launch differs from the first")
        keys = ("rgb_map", "acc_map", "weights", "last_weight")
        zc = stratified_sample(near, far, n_s, R, device=dev)
        e2 = [_agree(f"coarse {k}", kc[k], pc[k], corr=k == "rgb_map")
              for k in keys]
        e2.append(_agree("coarse z_all vs plain merge of the kernel's "
                         "weights", kz, fr.importance_depths(
                             zc, kc["weights"], n_i), atol=Z_ATOL))
        e1 = [_agree(f"fine {k}", kf[k], pf[k], corr=k == "rgb_map")
              for k in keys]
        res = {}
        for name, kernel, key, n, zz, cols, err in (
                ("fused_render_coarse_hier", "k_coarse_hier", "coarse", n_s,
                 zc, (9, 8 + n_s + S), max(e2)),
                ("fused_render_rays", "k_render_rays", "fine", S, z,
                 (9 + S, 8 + S), max(e1))):
            lib = _mlp_library_ms(fr, packed[key], o, d, zz)
            bnd = _ray_bound(ncfg, R, n, *cols)
            flops = 2.0 * R * (n * pt + ray)
            t = ms[key]
            dms = _device_ms(runs[key], kernel)
            res[name] = {"ms": t, "plain_ms": ms[key + " plain"],
                         "library_ms": lib, "max_abs_err": err,
                         "device_ms": dms, "host_ms": host[key],
                         "tflops": flops / t / 1e9,
                         "bound_share": bnd["bound_ms"] / t, **bnd}
            print(f"  {name} at R={R} ({tag}), S {n}: kernel {t:.3f} ms "
                  f"({flops / t / 1e9:.1f} TFLOP/s, "
                  f"{100 * bnd['bound_ms'] / t:.1f} % of the bound; "
                  f"profiled device time of one call {dms:.3f} ms, host "
                  "ms per timed call "
                  + ", ".join(f"{h:.2f}" for h in host[key]) + "), plain "
                  f"{ms[key + ' plain']:.3f} ms, torch.addmm chain of the MLP"
                  f" {lib:.3f} ms (yardstick, timed only), bound "
                  f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA "
                  "events)")
        out[tag] = res
        del first_c, first_f, z, last, runs, kc, kz, pc, kf, pf
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def _delta_keyframe(fr, nets, fold, c, o, d, b, near, far, n_s, n_i):
    """A real keyframe's fine depths and weights (K2 then K1) on the rays
    o, d: the first delta frame's previous (z, w)."""
    fc, ff = fold(nets["coarse"], c), fold(nets["fine"], c)
    _, z = fr.fused_render_coarse_hier(nets["coarse"], fc, c, o, d, b,
                                       near, far, n_s, n_i)
    return z, fr.fused_render_rays(nets["fine"], ff, c, o, d, z, b)["weights"]


def _delta_band(z, w, near, far):
    """The foreground band of (z, w), padded by 2 % of the interval."""
    from idealnerf_tpu_torch.core.composite import fg_band

    lo, hi, _ = fg_band(z, w)
    span = far - near
    return ((lo - 0.02 * span).clamp(near, far).contiguous(),
            (hi + 0.02 * span).clamp(near, far).contiguous())


def _delta_agree(k, again, p) -> float:
    """Two delta-kernel outputs bitwise equal, and against the plain
    version: depths, render, and the band of the kernel's own z, w."""
    import torch

    from idealnerf_tpu_torch.core.composite import fg_band

    if not all(torch.equal(k[key], again[key]) for key in k):
        raise AssertionError("two delta launches differ")
    print("  two launches bitwise equal")
    e = [_agree("z_vals vs plain placement", k["z_vals"], p["z_vals"],
                atol=Z_ATOL)]
    e += [_agree(key, k[key], p[key], corr=key == "rgb_map") for key
          in ("rgb_map", "acc_map", "weights", "last_weight")]
    b_lo, b_hi, _ = fg_band(k["z_vals"], k["weights"])
    e.append(_agree("band_lo vs plain band of the kernel's z, w",
                    k["band_lo"], b_lo, atol=Z_ATOL))
    e.append(_agree("band_hi vs plain band of the kernel's z, w",
                    k["band_hi"], b_hi, atol=Z_ATOL))
    return max(e)


def _delta_case(fr, nets, fold, c, o, d, b, near, far, n_s, n_i,
                s_delta: int, tag: str) -> float:
    """The delta kernel against its plain version on the rays o, d (plate
    b) at ``s_delta``: the previous (z, w) first from a real keyframe,
    then from the kernel's own output; two launches bitwise equal."""
    import torch

    s_uni, s_imp = _delta_split(s_delta)
    ff = fold(nets["fine"], c)
    z, w = _delta_keyframe(fr, nets, fold, c, o, d, b, near, far, n_s, n_i)
    err = 0.0
    for _ in range(2):   # from the keyframe, then from its own output
        lo, hi = _delta_band(z, w, near, far)
        args = (nets["fine"], ff, c, o, d, z, w, lo, hi, b, far, s_uni,
                s_imp)
        k = fr.fused_render_delta(*args)
        again = fr.fused_render_delta(*args)
        p = fr.fused_render_delta_reference(*args)
        lc = fr.delta_launch_config(s_uni + s_imp + 1, z.shape[1])
        print(f" fused_render_delta [{tag}, R={o.shape[0]}, s_prev "
              f"{z.shape[1]}, {s_uni} uniform + {s_imp} importance + plate]: "
              f"{lc['rays_per_group']} rays per group, "
              f"{lc['smem_bytes']} bytes of shared memory, a ring of "
              f"{lc['ring_stages']} stages of {lc['stage_bytes']} bytes")
        err = max(err, _delta_agree(k, again, p))
        z, w = k["z_vals"], k["weights"]
    torch.cuda.synchronize()
    return err


def _phase_delta(fr, nets, fold, ncfg, near, far, n_s, n_i, ro, rd, bc,
                 prior, ptxas) -> dict:
    """Phase 9: the delta kernel against its plain version, two launches
    bitwise equal, then timed at the phase-2 rays and at the prior rays
    of a 450x450 frame beside its torch.matmul yardstick; the timed
    launches are held against the first and the plain version there too."""
    import torch

    print("phase 9 temporal delta kernel vs plain version")
    for i, ln in enumerate(ptxas):  # the wgmma kernel's registers, spills
        if "k_render_delta" in ln:
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))

    def check(tag, c, n, s_delta):
        return _delta_case(fr, nets, fold, c, ro[:n], rd[:n], bc[:n], near,
                           far, n_s, n_i, s_delta, tag)

    sp = dataclasses.replace(ncfg, density_activation="softplus")
    rays = ro.shape[0]
    err = max(check("relu", ncfg, rays, 16),
              check("relu, ragged", ncfg, min(1001, rays), 16),
              check("softplus, ragged", sp, min(1001, rays), 16),
              check("relu, ragged, union of 16", ncfg, min(1001, rays), 17))

    # timing on steady-state inputs (s_prev 16), as a serving delta frame
    s_uni, s_imp = _delta_split(16)
    ff = fold(nets["fine"], ncfg)
    out = {"max_abs_err": err}
    for tag, (o, d, b) in (("phase-2 rays", (ro, rd, bc)),
                           ("450x450 prior rays", prior)):
        z, w = _delta_keyframe(fr, nets, fold, ncfg, o, d, b, near, far, n_s,
                               n_i)
        lo, hi = _delta_band(z, w, near, far)
        k = fr.fused_render_delta(nets["fine"], ff, ncfg, o, d, z, w, lo, hi,
                                  b, far, s_uni, s_imp)
        z, w = k["z_vals"], k["weights"]
        lo, hi = _delta_band(z, w, near, far)
        args = (nets["fine"], ff, ncfg, o, d, z, w, lo, hi, b, far, s_uni,
                s_imp)
        first = fr.fused_render_delta(*args)
        last = {}

        def kernel():
            last.update(fr.fused_render_delta(*args))

        def plain():
            last["plain"] = fr.fused_render_delta_reference(*args)

        ms = _time_ms(kernel, 5)
        pms = _time_ms(plain, 2)
        # the timed launches against the first, then against the plain
        # version at the timed size
        print(f"  R={o.shape[0]} ({tag}), s_prev 16: the last timed launch "
              "against the first, and against the plain version")
        err = max(err, _delta_agree(first, {key: last[key] for key in first},
                                    last["plain"]))
        lib = _mlp_library_ms(fr, fr.pack_operands(nets["fine"], ff, ncfg),
                              o, d, k["z_vals"])
        n = o.shape[0]
        bnd = _ray_bound(ncfg, n, 16, 9 + 2 * 16 + 2, 8 + 2 * 16)
        print(f"  fused_render_delta at R={n} ({tag}), s_prev 16, 3+12+1: "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"torch.addmm chain of the MLP "
              f"{lib:.3f} ms (yardstick, timed only), bound "
              f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA events)")
        out[n] = {"ms": ms, "plain_ms": pms, "library_ms": lib, **bnd}
        del z, w, k, args, first, last
    torch.cuda.synchronize()
    out["max_abs_err"] = err
    out.update(out[prior[0].shape[0]])
    return out


def _phase_serve(fr, nets, ncfg, cond, ds, prior_mask) -> dict:
    """Phase 10: cli.serve.main under the serving defaults and rolling,
    the delta geometry check, and a profiled steady delta frame."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli import serve
    from idealnerf_tpu_torch.eval.temporal import (
        make_temporal_frame_renderer,
    )

    H, W = ds.hw
    base = ["--synthetic", str(ds.size), "--synthetic_hw", str(H),
            "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
            "--device", "cuda"]
    out = {}
    for tag, extra, warm in (("defaults", [], WARMUP),
                             ("roll_k 4", ["--roll_k", "4", "--max_frames",
                                           "10"], WARMUP_ROLL)):
        fr.reset_launch_counts()
        stats = serve.main(base + extra)
        counts = dict(fr.launch_counts)
        live = {k: counts[k] - warm[k] for k in warm}
        n = stats["frames"]
        if extra:
            want = {"fused_render_coarse_hier": n, "fused_render_rays": n,
                    "fused_render_delta": n - 1}
        else:
            want = {"fused_render_coarse_hier": stats["keyframes"],
                    "fused_render_rays": stats["keyframes"],
                    "fused_render_delta": stats["delta_frames"]}
        print(f"phase 10 serve [{tag}]: {n} frames of {H}x{W}, "
              f"{stats['keyframes']} keyframes + {stats['delta_frames']} "
              f"delta frames; launches {counts} (live {live}, want {want}); "
              f"p50 {stats['p50_ms']:.2f} ms, p95 {stats['p95_ms']:.2f} ms, "
              f"steady {stats['steady_fps']:.2f} fps, keyframe "
              f"{stats['keyframe_ms']} ms, delta p50 {stats['delta_p50_ms']}"
              f" ms, warm-up {stats['warmup_s']:.2f} s")
        if not stats["finite"]:
            raise AssertionError(f"serve [{tag}] emitted a non-finite frame")
        if live != want:
            raise AssertionError(f"serve [{tag}] launched {live}, want {want}")
        out[tag] = {"stats": stats, "launches": counts}

    # a delta frame at the keyframe's own pose: the delta path's rays must
    # be the keyframe's (rotated pose, off-centre principal point)
    h = w = 64
    th = 0.35
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    pose = torch.from_numpy(np.concatenate(
        [rot, np.array([[0.3], [0.1], [0.9]], np.float32)], 1)).cuda()
    bc64 = torch.rand(h, w, 3, generator=torch.Generator().manual_seed(4))
    tm = make_temporal_frame_renderer(ncfg, h, w, 96.0, 0.5, 1.5,
                                      _render_cfg(), cx=w * 0.41,
                                      cy=h * 0.57, s_delta=32)
    kf, c0 = tm(nets, pose, bc64.cuda(), *cond)
    dl, _ = tm(nets, pose, bc64.cuda(), *cond, cache=c0)
    psnr = float(-10.0 * torch.log10(((kf - dl) ** 2).mean() + 1e-12))
    print(f"  delta frame at the keyframe's pose (rotated, off-centre, "
          f"s_delta 32, {h}x{w}): PSNR {psnr:.2f} dB against the keyframe "
          f"(> {MIN_GEOMETRY_PSNR:g})")
    if not psnr > MIN_GEOMETRY_PSNR:
        raise AssertionError("delta-frame rays disagree with the keyframe's")
    out["geometry_psnr"] = psnr

    # one steady delta frame of the serving configuration, profiled
    tm = make_temporal_frame_renderer(
        ncfg, H, W, ds.focal, ds.near, ds.far, _render_cfg(), cx=ds.cx,
        cy=ds.cy, prior_mask=prior_mask, s_delta=16)
    pose = torch.from_numpy(ds.poses[1]).cuda()
    bc = torch.from_numpy(ds.bc_img).cuda().float() / 255
    _, c = tm(nets, torch.from_numpy(ds.poses[0]).cuda(), bc, *cond)
    _, c = tm(nets, pose, bc, *cond, cache=c)
    prof = _profile(lambda: tm(nets, pose, bc, *cond, cache=c),
                    f"steady delta frame ({H}x{W}, prior, s_delta 16)",
                    "profile_delta_frame.txt")
    prof["k3_ms"] = sum(ms for k, ms, _ in prof["top"]
                        if "k_render_delta" in k)
    out["profile"] = prof
    torch.cuda.synchronize()
    return out


def _plan_text(lc: dict) -> str:
    return (f"{lc['rays_per_group']} rays per block, {lc['smem_bytes']} "
            f"bytes of shared memory, a ring of {lc['ring_stages']} stages "
            f"of {lc['stage_bytes']} bytes")


def _render_cfg():
    from idealnerf_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(dim_aud=64, dim_expr=76,
                            dim_latent=32).render_config()


def _norm_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / (want.norm() + 1e-12))


def _grads_of(train_fn, model, folded_fn, cond, pts, dirs, w):
    """(per-parameter gradients, conditioning gradients) of
    sum(raw * w) through ``train_fn``."""
    c = [x.detach().clone().requires_grad_(True) for x in cond]
    model.zero_grad(set_to_none=True)
    raw = train_fn(model, folded_fn(model, c), pts, dirs)
    (raw * w).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, [x.grad.detach().clone() for x in c]


def _phase_point_mlp(fm, fr, net, folded, ncfg, pts, dirs, ptxas,
                     so_path) -> dict:
    """Phase 6: K4's (and K5's) ptxas lines and HGMMA counts; K4 against its
    plain version at the training step's coarse and fine passes, at
    ``pts``' size and ragged, each case's two launches and another plan
    bitwise equal; then timed at ``pts``' size beside its plain version and
    the torch.addmm yardstick, the last timed launch held bitwise against
    the first."""
    import torch

    print("phase 6 fused point MLP (K4) vs plain version")
    names = ("11k_point_mlp", "14k_point_mlp_pe")
    for i, ln in enumerate(ptxas):
        if any(f"Function properties for _ZN2fr{k}" in ln for k in names):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
    hgmma = _hgmma_counts(so_path, names)
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    if not all(hgmma[k] > 0 for k in names):
        raise AssertionError(f"a point kernel has no HGMMA: {hgmma}")
    packed = fr.pack_operands(net, folded, ncfg)
    n = pts.shape[0]
    sizes = sorted({m for m in (*STEP_POINTS, n) if m <= n}, reverse=True)
    err, first = 0.0, None
    for m in sizes + [1001, 1]:
        p, d = pts[:m], dirs[:m]
        lc = fm.point_launch_config(m)
        got = fm.fused_point_mlp(net, folded, ncfg, p, d)
        again = fm.fused_point_mlp(net, folded, ncfg, p, d)
        plan = (max(1, lc["tiles_per_block"] // 2), 3)
        other = fm.launch_point_kernel(packed, p, d, False, plan)
        want = fm.fused_point_mlp_reference(net, folded, ncfg, p, d)
        same = torch.equal(got, again) and torch.equal(got, other)
        print(f" fused_point_mlp N={m}: {lc['tiles_per_block']} tiles x "
              f"{lc['blocks']} blocks, {lc['smem_bytes']} bytes of shared "
              f"memory, a ring of {lc['ring_stages']} stages of "
              f"{lc['stage_bytes']} bytes; two launches and the plan of "
              f"{plan[0]} tiles per block, ring {plan[1]}, bitwise equal: "
              f"{same}")
        if not same:
            raise AssertionError("K4's launches or plans differ")
        # one point has no correlation: N = 1 is held to the bound alone
        for c in range(4):
            err = max(err, _agree(f"N={m} raw[:, {c}]", got[:, c],
                                  want[:, c], corr=m > 1))
        if m == n:
            first = got
        del got, again, other, want
    torch.cuda.synchronize()
    # the kernels line's span, as the parent's: the wrapper that packs the
    # net on every call (as K1/K2's in phase 2), over 20 calls (its host
    # packing spreads between runs), and its plain version
    last, host, point_host = {}, [], []
    ms = _time_ms(lambda: last.update(k=fm.fused_point_mlp(
        net, folded, ncfg, pts, dirs)), 20, host)
    pms = _time_ms(lambda: last.update(p=fm.fused_point_mlp_reference(
        net, folded, ncfg, pts, dirs)), 2)
    same = torch.equal(first, last["k"])
    print(f"  N={n}: the last timed launch bitwise equal to the first: "
          f"{same}; against the plain version:")
    if not same:
        raise AssertionError("a timed K4 launch differs from the first")
    for c in range(4):
        err = max(err, _agree(f"N={n} timed raw[:, {c}]", last["k"][:, c],
                              last["p"][:, c], corr=True))
    del last, first
    # beside it: the kernel on a packed net (weight stream + launch), its
    # host ms and the profiled device time of one call
    point_ms = _time_ms(lambda: fm.point_mlp(packed, pts, dirs), 5,
                        point_host)
    dms = _device_ms(lambda: fm.point_mlp(packed, pts, dirs), "k_point_mlp")
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(packed, pts, dirs))
    lib = _point_library_ms(packed, pe, ped)
    del pe, ped
    bnd = _point_bound(ncfg, n, False)
    pt, ray = _mlp_macs(ncfg)
    flops = 2.0 * n * (pt + ray)
    print(f"  fused_point_mlp at N={n}: {ms:.3f} ms through fused_point_mlp "
          "(packs the net every call; host ms per timed call "
          + ", ".join(f"{h:.2f}" for h in host) + f"), plain {pms:.3f} ms; "
          f"through point_mlp on a packed net {point_ms:.3f} ms "
          f"({flops / point_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bnd['bound_ms'] / point_ms:.1f} % of the bound; host ms "
          "per timed call " + ", ".join(f"{h:.2f}" for h in point_host)
          + f"), profiled device time of one call {dms:.3f} ms "
          f"({100 * bnd['bound_ms'] / dms:.1f} % of the bound); torch.addmm "
          f"chain of the MLP {lib:.3f} ms (yardstick, timed only); bound "
          f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA events)")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "library_ms": lib, "host_ms": host, "point_mlp_ms": point_ms,
            "point_mlp_host_ms": point_host, "device_ms": dms,
            "hgmma": hgmma, "tflops": flops / point_ms / 1e9, **bnd}


def _grad_checks(fmg, tag, gd, ncfg, net, cond, pts, dirs, ref, ref_c, w):
    """The kernel's gradients through the training autograd Function
    against the plain backward and f32 autograd per parameter, the
    conditioning gradients, and two launches bitwise equal -> (max abs
    error against the plain backward, worst errors, packed operands,
    cotangent)."""
    import torch

    from idealnerf_tpu_torch.kernels.fused_render import (
        model_leaves, pack_leaves,
    )
    from idealnerf_tpu_torch.models.face_nerf import fold_conditioning

    n = pts.shape[0]

    def folded_fn(model, c):
        return fold_conditioning(model, ncfg, *c)

    def kern(model, folded, p, d):
        return fmg.fused_point_mlp_train(ncfg, model, folded, p, d, gd)

    def plain(model, folded, p, d):
        return fmg.fused_point_mlp_train_reference(ncfg, model, folded, p, d,
                                                   gd)

    got, got_c = _grads_of(kern, net, folded_fn, cond, pts, dirs, w)
    want, _ = _grads_of(plain, net, folded_fn, cond, pts, dirs, w)
    worst = {"plain": (0.0, ""), "autograd": (0.0, "")}
    err = 0.0
    for name in ref:
        for what, r in (("plain", want[name]), ("autograd", ref[name])):
            e = _norm_rel(got[name], r)
            if e > worst[what][0]:
                worst[what] = (e, name)
        err = max(err, float((got[name] - want[name]).abs().max()))
    for what, (e, name) in worst.items():
        tol = GRAD_TOL[tag][what]
        print(f"  {tag} N={n}: worst norm-relative error vs {what} {e:.3e} "
              f"({name}; tol {tol:g})")
        if not e <= tol:
            raise AssertionError(f"{tag} gradients disagree with {what}")
    for x, r, name in zip(got_c, ref_c, ("aud", "expr", "latent")):
        scale = float(r.abs().max())
        e = float((x - r).abs().max()) / (scale + 1e-12)
        print(f"  {tag} N={n}: d{name} max error {e:.3e} relative to its "
              f"max {scale:.3e} (tol {COND_TOL:g})")
        if not (e < COND_TOL and float(x.abs().max()) > 0):
            raise AssertionError(f"{tag} d{name} disagrees or is zero")

    # bitwise repeatability of the kernels themselves, on packed operands
    folded = fold_conditioning(net, ncfg, *cond)
    packed = pack_leaves(ncfg, model_leaves(net, folded, ncfg), gd)
    g = (w * n).contiguous()
    a = fmg.point_mlp_grad(packed, pts, dirs, g)
    b = fmg.point_mlp_grad(packed, pts, dirs, g)
    same = all(torch.equal(x, y) for x, y in zip(_packed_list(a),
                                                  _packed_list(b)))
    print(f"  {tag} N={n}: two launches bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{tag} gradient kernel is not repeatable")
    return err, {k: v[0] for k, v in worst.items()}, packed, g


def _packed_list(p):
    return [*p.w, *p.b, *p.wskip.values(), *p.wv, *p.bv, p.wv0d, p.w_alpha,
            p.w_rgb, p.b_heads]


def _packed_names(p):
    """The names of _packed_list's operands, in its order."""
    return ([f"w{i}" for i in range(len(p.w))]
            + [f"b{i}" for i in range(len(p.b))]
            + [f"wskip{i}" for i in p.wskip]
            + [f"wv{v}" for v in range(len(p.wv))]
            + [f"bv{v}" for v in range(len(p.bv))]
            + ["wv0d", "w_alpha", "w_rgb", "b_heads"])


def _plane_bytes(fmg, packed, n: int, f32: bool = False) -> float:
    """Bytes of the operand planes and bias rows a backward's pass A
    writes on n points (bf16 or f32 planes)."""
    n_tiles = -(-n // fmg.GRAD_TILE)
    planes = fmg.grad_planes_f32 if f32 else fmg.grad_planes
    nb = sum(x.numel() for x in packed.b) + sum(
        x.numel() for x in packed.bv) + packed.b_heads.numel()
    return (4 if f32 else 2) * planes(packed, n_tiles)[2] + 4 * n_tiles * nb


def _pass_bounds(fmg, ncfg, packed, n: int, f32: bool = False):
    """Bounds of a backward's two passes on n points: pass A does the
    forward's and the input gradients' multiply-adds and writes the
    operand planes and bias rows; pass B does every weight gradient's
    multiply-adds and reads them (bf16 tensor-core or f32 rates)."""
    kind = "f32" if f32 else "bf16"
    out_bytes = _plane_bytes(fmg, packed, n, f32)
    macs_a, macs_b = _grad_macs(ncfg)
    a = _bound(2.0 * n * macs_a,
               _weight_bytes(ncfg) + 4.0 * n * (6 + 4) + out_bytes, kind)
    _, G = fmg._grad_layout(packed)
    b = _bound(2.0 * n * macs_b, out_bytes + 4.0 * G, kind)
    return a, b


def _check_pass_a(fmg, packed, pts, dirs, g, f32: bool = False):
    """Pass A's own outputs against grad_pass_a_reference on the same
    inputs, and against the same computation in f64: every plane,
    unswizzled, no farther from the f64 one, norm-relative, than twice
    the plain version's own distance from it (at least PASS_A_FLOOR), and
    with a correlation above MIN_CORR against the plain version; the bias
    rows within PASS_A_TOL norm-relative of the plain version's; a second
    launch bitwise equal -> (max abs error against the plain version, the
    launch's planes, offsets, bias rows and buffers). The three sum the
    same products in other orders, so a bf16 value may round one ulp
    apart, and where an activation rounds to 0 in one order and not in
    another its relu' flips: the d_h element it gates differs by its whole
    value and the rows it feeds move with it. So no absolute bound holds
    on the d_h planes, not even for the plain version against f64. With
    ``f32``, pass A f32 (f32 weights, row-major f32 planes) at the
    floor of the f32 emulation test, PASS_A_F32_FLOOR, and its bias rows
    held like the planes."""
    import torch

    n = pts.shape[0]
    planes, offs, bias = fmg.grad_pass_a(packed, pts, dirs, g)
    again = fmg.grad_pass_a(packed, pts, dirs, g)
    same = torch.equal(again[0], planes) and torch.equal(again[2], bias)
    del again
    got = (fmg.buffers_from_planes_f32 if f32 else fmg.buffers_from_planes)(
        packed, planes, offs, bias, n)
    floor = PASS_A_F32_FLOOR if f32 else PASS_A_FLOOR

    def planes_of(bufs):
        out = {"pe": bufs.pe, "ped": bufs.ped, "gb": bufs.gb}
        if f32:
            out["bias"] = bufs.bias
        for key in ("hs", "hvs", "dcs", "dvs"):
            for j, x in enumerate(getattr(bufs, key)):
                out[f"{key[:-1]}{j}"] = x
        return out

    want = fmg.grad_pass_a_reference(packed, pts, dirs, g)
    bias_err = _norm_rel(got.bias, want.bias)
    mine, plain = planes_of(got), planes_of(want)
    exact = planes_of(fmg.grad_pass_a_reference(packed, pts, dirs, g,
                                                torch.float64))
    err, corr, ratio = 0.0, (1.0, ""), (0.0, "", 0.0, 0.0, 0.0)
    for name, x in exact.items():
        a, b = mine[name], plain[name]
        if not torch.isfinite(a).all():
            raise AssertionError(f"pass A: non-finite {name}")
        err = max(err, float((a - b).abs().max()))
        if n > 1:
            c = float(torch.corrcoef(torch.stack([a.reshape(-1),
                                                  b.reshape(-1)]))[0, 1])
            corr = min(corr, (c, name))
        far, own = _norm_rel(a.double(), x), _norm_rel(b.double(), x)
        ratio = max(ratio, (far / max(2 * own, floor), name, far,
                            own, float((b.double() - x).abs().max())))
    del want, plain, exact
    print(f"  pass A{' f32' if f32 else ''} alone vs its plain version, "
          f"N={n}: {len(mine)} planes, "
          f"max_abs_err {err:.3e}; the kernel's distance from f64 at most "
          f"{ratio[0]:.3f} of twice the plain version's ({ratio[1]}: "
          f"{ratio[2]:.3e} and {ratio[3]:.3e} norm-relative, the plain "
          f"version {ratio[4]:.3e} from f64 at most; tol 1, floor "
          f"{floor:g}); correlation at least {corr[0]:.6f} "
          f"({corr[1]}; > {MIN_CORR}); bias rows norm-relative "
          f"{bias_err:.3e} (tol {PASS_A_TOL:g}); two launches bitwise "
          f"equal: {same}")
    if not (ratio[0] <= 1.0 and corr[0] > MIN_CORR
            and bias_err <= PASS_A_TOL):
        raise AssertionError("pass A disagrees with its plain version")
    if not same:
        raise AssertionError("pass A is not repeatable")
    return err, planes, offs, bias, got


def _phase_grad_split(fmg, ncfg, packed, pts, dirs, g, ms: float,
                      f32: bool = False) -> dict:
    """A backward's passes apart (``ms``: the whole backward's time), bf16
    or, with ``f32``, f32: pass A alone against its plain version and f64
    (_check_pass_a), pass B alone against its plain version on pass A's
    own buffers (PASS_B_TOL norm-relative per gradient), each pass timed
    with CUDA events, each pass's bound with the planes' bytes, the peak
    memory of one backward call, and a yardstick, timed only: in bf16
    torch.bmm of the trunk's H^T @ dc products; in f32 f32 autograd of the
    plain MLP (cuBLAS, TF32 off, ``library_ms``), beside each pass's plain
    version's time."""
    import torch

    n = pts.shape[0]
    err_a, planes, offs, bias, bufs = _check_pass_a(fmg, packed, pts, dirs,
                                                    g, f32)
    got = fmg.grad_pass_b(packed, planes, offs, bias)
    n_chunks = fmg.grad_chunks(bias.shape[0], torch.cuda.get_device_properties(
        pts.device).multi_processor_count)
    want = fmg.grad_pass_b_reference(packed, bufs, n_chunks)
    pairs = list(zip(_packed_list(got), _packed_list(want)))
    worst = max(_norm_rel(x, y) for x, y in pairs)
    err_b = max(float((x - y).abs().max()) for x, y in pairs)
    tag = "f32" if f32 else "bf16"
    print(f"  pass B {tag} alone vs its plain version on pass A's buffers, "
          f"N={n}: worst norm-relative error {worst:.3e} (tol "
          f"{PASS_B_TOL:g}), max_abs_err {err_b:.3e}")
    if not worst <= PASS_B_TOL:
        raise AssertionError(f"pass B {tag} disagrees with its plain version")
    del got, want, pairs
    out = {"pass_a_ms": _time_ms(lambda: fmg.grad_pass_a(packed, pts, dirs,
                                                         g), 3),
           "pass_b_ms": _time_ms(lambda: fmg.grad_pass_b(packed, planes,
                                                         offs, bias),
                                 3 if f32 else 5)}
    D = len(packed.w)
    if f32:
        out["pass_a_plain_ms"] = _time_ms(
            lambda: fmg.grad_pass_a_reference(packed, pts, dirs, g), 2)
        out["pass_b_plain_ms"] = _time_ms(
            lambda: fmg.grad_pass_b_reference(packed, bufs, n_chunks), 2)
        del bufs, planes, bias
        out["library_ms"] = _time_ms(
            lambda: _autograd_packed_grad(packed, pts, dirs, g), 3)
        plain = (f"plain {out['pass_a_plain_ms']:.3f}; ",
                 f"plain {out['pass_b_plain_ms']:.3f}; ")
        lib = (f"f32 autograd of the plain MLP (cuBLAS, TF32 off) "
               f"{out['library_ms']:.3f} ms")
    else:
        hts = torch.stack([x.to(torch.bfloat16) for x in bufs.hs[:D - 1]]
                          ).transpose(1, 2)
        dcs = torch.stack([x.to(torch.bfloat16) for x in bufs.dcs[1:]])
        del bufs, planes, bias
        out["bmm_ms"] = _time_ms(lambda: torch.bmm(hts, dcs), 5)
        del hts, dcs
        plain = ("", "")
        lib = (f"torch.bmm of the {D - 1} trunk H^T @ dc products "
               f"{out['bmm_ms']:.3f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fmg.point_mlp_grad(packed, pts, dirs, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    bound_a, bound_b = _pass_bounds(fmg, ncfg, packed, n, f32)
    gib = _plane_bytes(fmg, packed, n, f32)
    whole = _point_bound(ncfg, n, True, tag, gib)
    print(f"  {tag} passes at N={n}: pass A {out['pass_a_ms']:.3f} ms "
          f"({plain[0]}bound {bound_a['bound_ms']:.3f}, "
          f"{bound_a['bound_by']}), pass B {out['pass_b_ms']:.3f} ms "
          f"({plain[1]}bound {bound_b['bound_ms']:.3f}, "
          f"{bound_b['bound_by']}); the whole backward {ms:.3f} ms against "
          f"its bound {whole['bound_ms']:.3f} ({whole['bound_by']}, the "
          f"planes' {gib / 2 ** 30:.3f} GiB written and read; "
          f"{100 * whole['bound_ms'] / ms:.1f} %); {lib} (yardstick, timed "
          f"only); peak memory of one call {peak / 2 ** 30:.3f} GiB (CUDA "
          "events)")
    out.update(pass_a_err=err_a, pass_b_err=err_b, pass_b_worst=worst,
               peak_bytes=peak, bound_a=bound_a, bound_b=bound_b,
               bound_whole=whole)
    return out


def _packed_from_list(net, xs):
    """A PackedNet like ``net`` holding the tensors ``xs`` in
    _packed_list's order."""
    it = iter(xs)

    def take(k):
        return [next(it) for _ in range(k)]

    D, V = len(net.w), len(net.wv)
    w, b = take(D), take(D)
    wskip = dict(zip(net.wskip, take(len(net.wskip))))
    wv, bv = take(V), take(V)
    wv0d, w_alpha, w_rgb, b_heads = take(4)
    return dataclasses.replace(net, w=w, b=b, wskip=wskip, wv=wv, bv=bv,
                               wv0d=wv0d, w_alpha=w_alpha, w_rgb=w_rgb,
                               b_heads=b_heads)


def _autograd_packed_grad(net, pts, dirs, g):
    """The f32 backward's function by f32 autograd (cuBLAS, TF32 off) of
    the plain MLP on a packed f32 net: gradients of sum(raw * g) over
    every packed operand -> a PackedNet. K6 f32's yardstick, and the
    backward phase 16 swaps in to hold the kernels' on a step's own
    cotangent."""
    import torch

    from idealnerf_tpu_torch.kernels.fused_mlp import encode_points

    leaves = [x.detach().float().requires_grad_(True)
              for x in _packed_list(net)]
    p = _packed_from_list(net, leaves)
    with torch.enable_grad():
        pe, ped = encode_points(p, pts, dirs)
        h = torch.relu(pe @ p.w[0] + p.b[0])
        for i in range(1, len(p.w)):
            a = h @ p.w[i]
            if i in p.wskip:
                a = pe @ p.wskip[i] + a
            h = torch.relu(a + p.b[i])
        hv = torch.relu(h @ p.wv[0] + ped @ p.wv0d + p.bv[0])
        for v in range(1, len(p.wv)):
            hv = torch.relu(hv @ p.wv[v] + p.bv[v])
        raw = (h @ p.w_alpha + hv @ p.w_rgb + p.b_heads)[:, :4]
        grads = torch.autograd.grad(raw, leaves, g)
    return _packed_from_list(net, grads)


def _phase_grad(net, ncfg, cond, pts, dirs, ptxas, so_path) -> dict:
    import torch

    from idealnerf_tpu_torch.core.embedding import positional_encoding
    from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
    from idealnerf_tpu_torch.kernels.fused_render import (
        model_leaves, pack_leaves,
    )
    from idealnerf_tpu_torch.models.face_nerf import (
        apply_folded, fold_conditioning,
    )

    print("phase 7 gradient kernel vs plain backward and f32 autograd")
    for i, ln in enumerate(ptxas):  # the W=256 passes' registers, spills
        if (any(k in ln for k in ("k_grad_pass", "k_bias_partials"))
                and "LayoutILi256" in ln):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
            if "k_grad_pass_a" in ln and not any(
                    "0 bytes spill stores, 0 bytes spill loads" in x
                    for x in ptxas[i:i + 3]):
                raise AssertionError("pass A (bf16 or f32) spills")
    # mangled names: bf16 pass A, and the f32 passes
    a16, f32_names = "13k_grad_pass_aI", ("17k_grad_pass_a_f32",
                                          "17k_grad_pass_b_f32")
    ops = {op: _hgmma_counts(so_path, (a16, *f32_names), op)
           for op in ("HGMMA", "HMMA", "FFMA")}
    print(f"  k_grad_pass_a SASS: {ops['HGMMA'][a16]} HGMMA (wgmma), "
          f"{ops['HMMA'][a16]} HMMA (wmma); f32 passes: " + ", ".join(
              f"{k[2:]} {ops['HGMMA'][k]} HGMMA, {ops['HMMA'][k]} HMMA, "
              f"{ops['FFMA'][k]} FFMA" for k in f32_names))
    if not (ops["HGMMA"][a16] > 0 and ops["HMMA"][a16] == 0):
        raise AssertionError(f"k_grad_pass_a is not on the wgmma chain: {ops}")
    if not all(ops["HGMMA"][k] == ops["HMMA"][k] == 0 < ops["FFMA"][k]
               for k in f32_names):
        raise AssertionError(f"an f32 pass runs a tensor-core product: {ops}")

    def folded_fn(model, c):
        return fold_conditioning(model, ncfg, *c)

    def autograd_fn(model, folded, p, d):
        return apply_folded(model, folded, ncfg,
                            positional_encoding(p, ncfg.multires),
                            positional_encoding(d, ncfg.multires_views))

    out = {"max_abs_err": 0.0}
    sizes = [pts.shape[0]] + [FINE_POINTS] * (FINE_POINTS < pts.shape[0])
    for n in sizes:
        p, d = pts[:n], dirs[:n]
        w = (torch.linspace(0.5, 1.5, n, device=pts.device)[:, None]
             * torch.tensor([1.0, -0.7, 0.3, 0.05], device=pts.device)) / n
        ref, ref_c = _grads_of(autograd_fn, net, folded_fn, cond, p, d, w)
        tags = (("f32", torch.float32), ("bf16", torch.bfloat16))
        for tag, gd in tags if n == pts.shape[0] else tags[1:]:
            err, worst, packed, g = _grad_checks(
                fmg, tag, gd, ncfg, net, cond, p, d, ref, ref_c, w)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            ms = _time_ms(lambda: fmg.point_mlp_grad(packed, p, d, g), 3)
            pms = _time_ms(lambda: fmg.point_mlp_grad_reference(
                packed, p, d, g), 2)
            bnd = _point_bound(ncfg, n, True, tag)
            print(f"  {tag} gradient kernel at N={n}: kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms (CUDA events); bound "
                  f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} at the "
                  f"{tag} peak")
            res = {"n": n, "ms": ms, "plain_ms": pms, "worst": worst, **bnd}
            res.update(_phase_grad_split(fmg, ncfg, packed, p, d, g, ms,
                                         tag == "f32"))
            if tag == "bf16":
                out["max_abs_err"] = max(out["max_abs_err"],
                                         res["pass_a_err"])
            out[f"{tag}_{n}"] = res
            del packed, g
            torch.cuda.synchronize()
        del ref, ref_c
        torch.cuda.empty_cache()
    # a ragged size: a part-filled 128-point tile and 64-point plane tile
    folded = fold_conditioning(net, ncfg, *cond)
    packed = pack_leaves(ncfg, model_leaves(net, folded, ncfg))
    n = 1001
    g = (torch.linspace(0.5, 1.5, n, device=pts.device)[:, None]
         * torch.tensor([1.0, -0.7, 0.3, 0.05], device=pts.device))
    out["pass_a_1001_err"] = _check_pass_a(fmg, packed, pts[:n], dirs[:n],
                                           g.contiguous())[0]
    out["max_abs_err"] = max(out["max_abs_err"], out["pass_a_1001_err"])
    packed32 = pack_leaves(ncfg, model_leaves(net, folded, ncfg),
                           torch.float32)
    out["pass_a_f32_1001_err"] = _check_pass_a(
        fmg, packed32, pts[:n], dirs[:n], g.contiguous(), f32=True)[0]
    print("  pass A f32 launch at N={}: {}".format(
        pts.shape[0], fmg.pass_a_launch_config(packed32, pts.shape[0])))
    print("  pass A launch at N={}: {}".format(
        pts.shape[0], fmg.pass_a_launch_config(packed, pts.shape[0])))
    main = out[f"bf16_{pts.shape[0]}"]
    out["ms"], out["plain_ms"] = main["ms"], main["plain_ms"]
    return out


def _train_launches(fm, fmg, steps: int, train_fused: int = 2):
    """(the point kernels' launch counts of a train_head run, what its
    ``steps`` steps at ``train_fused`` 1 or 2 must launch): K4 and the
    backward twice a step (coarse and fine), through the bf16 or the f32
    passes, and the other variant's passes never."""
    got = {"fused_point_mlp": fm.launch_counts["fused_point_mlp"],
           **fmg.launch_counts}
    f32 = train_fused == 1
    want = {"fused_point_mlp": 2 * steps, "fused_point_mlp_grad": 2 * steps,
            "grad_pass_a": 0 if f32 else 2 * steps,
            "grad_pass_b": 0 if f32 else 2 * steps,
            "grad_pass_a_f32": 2 * steps if f32 else 0,
            "grad_pass_b_f32": 2 * steps if f32 else 0}
    return got, want


def _phase_train(args, fm, fmg, fr) -> dict:
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import render_val, train_head

    dims = ["--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32"]
    data = ["--synthetic", str(args.train_frames), "--synthetic_hw",
            str(args.train_hw)]
    shutil.rmtree("output/chip_smoke_train", ignore_errors=True)  # no resume
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_head.main([
        *data, *dims, "--N_rand", "2048", "--N_samples", "64",
        "--N_importance", "128", "--epochs", str(args.train_epochs),
        "--i_print", "5", "--i_weights", "10", "--device", "cuda",
        "--basedir", "output/chip_smoke_train", "--expname", "head"])
    steps = res["step"]
    counts, want = _train_launches(fm, fmg, steps)
    first, last = res["history"][0][1], res["history"][-1][1]
    print(f"phase 8 train_head: {steps} steps on {args.train_frames} frames "
          f"of {args.train_hw}x{args.train_hw}, D=8 W=256 N_rand 2048 64+128; "
          f"loss {first['loss']:.5f} -> "
          f"{last['loss']:.5f}, PSNR {first['psnr']:.3f} -> "
          f"{last['psnr']:.3f}; launches {counts}")
    vals = [first["loss"], last["loss"], first["psnr"], last["psnr"]]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("train_head produced a non-finite loss or PSNR")
    if counts != want:
        raise AssertionError(f"train_head launched {counts} for {steps} "
                             f"steps, want {want}")
    ck = CheckpointManager(res["ckpt_dir"])
    if ck.latest_step() != steps:
        raise AssertionError(f"no checkpoint at step {steps} in "
                             f"{res['ckpt_dir']}")
    fr.reset_launch_counts()
    rv = render_val.main([*data, *dims, "--head_ckpt", res["ckpt_dir"],
                          "--max_frames", "1", "--device", "cuda",
                          "--save_path", "output/chip_smoke_train"])
    print(f"  render_val --head_ckpt (step {steps}): PSNR {rv['psnr']:.3f}, "
          f"SSIM {rv['ssim']:.4f}, {rv['frame_ms']:.1f} ms, launches "
          f"{dict(fr.launch_counts)}")
    if not math.isfinite(rv["psnr"]):
        raise AssertionError("the trained checkpoint rendered non-finite")
    torch.cuda.synchronize()
    return {"steps": steps, "first": first, "last": last,
            "launches": counts, "render_psnr": rv["psnr"],
            "ckpt_dir": res["ckpt_dir"]}


def _points(ro, rd, near, far, n):
    """n points on the phase-2 rays at seeded uniform depths in [near,
    far], and their unit view directions."""
    import torch

    dev = ro.device
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.arange(n, device=dev) % ro.shape[0]
    z = near + (far - near) * torch.rand(n, 1, generator=g, device=dev)
    pts = (ro[idx] + rd[idx] * z).contiguous()
    dirs = (rd / rd.norm(dim=-1, keepdim=True))[idx].contiguous()
    return pts, dirs


def _phase_k5(fm, fr, model, folded, ncfg, pts, dirs) -> dict:
    """Phase 11a: K5 against its plain version at the phase-6 points and
    a ragged 1,001, then timed beside K4 on the same points (a finding:
    K5's entry is timed on its own path, kdiag2 rung v3)."""
    import torch

    print("phase 11 encoded-input point MLP (K5) vs plain version")
    err = 0.0
    for n in (pts.shape[0], 1001):
        got = fm.fused_point_mlp(model, folded, ncfg, pts[:n], dirs[:n],
                                 fuse_pe=False)
        want = fm.fused_point_mlp_reference(model, folded, ncfg, pts[:n],
                                            dirs[:n])
        for c in range(4):
            err = max(err, _agree(f"N={n} raw[:, {c}]", got[:, c],
                                  want[:, c], corr=True))
    net = fr.pack_operands(model, folded, ncfg)
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(net, pts, dirs))
    n = pts.shape[0]
    ms = _time_ms(lambda: fm.point_mlp_pe(net, pe, ped), 5)
    k4 = _time_ms(lambda: fm.point_mlp(net, pts, dirs), 5)
    wrapper = _time_ms(lambda: fm.fused_point_mlp(model, folded, ncfg, pts,
                                                  dirs, fuse_pe=False), 5)
    print(f"  K5 at N={n}: kernel {ms:.3f} ms on bf16 encodings (K4 on the "
          f"same points {k4:.3f} ms: in-kernel PE {k4 - ms:+.3f} ms), "
          f"fused_point_mlp(fuse_pe=False) with its torch PE {wrapper:.3f} "
          "ms (CUDA events)")
    return {"max_abs_err": err, "ms": ms, "k4_ms": k4, "wrapper_ms": wrapper}


def _check_probes(kd, fm, fr, probe, pts, dirs) -> dict:
    """Phase 11b: every probe kernel against its plain version at a ragged
    1,001 rows (a part-filled last tile): the bf16 chain in every mode at
    both plans and depth 2, 8 and 16, the f32 chain (128 rows per block),
    the int8 chains (i0, i1) at both plans and depth 2 and 8, the
    ladder's rungs v0-v2, and the render probes at S 64 and 192 -> max
    error by kernel entry (the chains' relative to their plain output's
    max abs)."""
    import torch

    from idealnerf_tpu_torch import scripts as sc
    from idealnerf_tpu_torch.scripts import kdiag3

    print("phase 11 kernel-diagnosis probes vs plain versions, ragged")
    model, folded, pcfg, net = probe
    dev = pts.device
    err = dict.fromkeys(("kdiag_chain", "kdiag4_chain", "kdiag4_chain_f32",
                         "kdiag5_chain", "kdiag2_ladder", "kdiag3_render_a",
                         "kdiag3_render_b", "kdiag3_render_c"), 0.0)
    # the chain modes of each TPU probe (kdiag.py, kdiag4.py, kdiag5.py)
    users = {"cast": ("kdiag_chain", "kdiag4_chain"),
             "bias_relu": ("kdiag_chain", "kdiag4_chain"),
             "relu2": ("kdiag_chain",),
             "relu": ("kdiag4_chain", "kdiag5_chain"),
             "select": ("kdiag4_chain",), "cast_max": ("kdiag4_chain",),
             "sum": ("kdiag4_chain",)}
    rows = 1001
    # the bf16 chain (wgmma) at depth 2, 8 and 16; the f32 one at kdiag4's 8
    for dtype, rpbs, depths in ((torch.bfloat16, (64, 128), (2, 8, 16)),
                                (torch.float32, (128,), (8,))):
        check = sc.chain_check(dtype)
        for depth in depths:
            x, ws = sc.chain_inputs(rows, dtype, dev, seed=11, depth=depth)
            # kdiag4 V6's bias, li + 1 in layer li
            bias = (torch.arange(depth, device=dev, dtype=torch.float32)[
                :, None] + 1.0).expand(depth, 256).contiguous()
            for mode in kd.CHAIN_MODES[dtype]:
                b = bias if mode in ("bias_relu", "relu2") else None
                want = kd.chain_reference(x, ws, mode, b)
                for rpb in rpbs:
                    e = check(f"chain {str(dtype)[6:]} {mode} r{rpb} rows "
                              f"{rows} depth {depth}",
                              kd.chain(x, ws, mode, b, rpb), want)
                    for k in users[mode] if dtype == torch.bfloat16 else (
                            "kdiag4_chain_f32",):
                        err[k] = max(err[k], e)
    x, ws = sc.chain_inputs(rows, torch.bfloat16, dev, seed=12)
    b = torch.zeros(8, 256, device=dev)
    err["kdiag_chain"] = max(err["kdiag_chain"], sc.chain_check(
        torch.bfloat16)(f"chain bf16 relu2 r128 rows {rows}, bf16 out",
                        kd.chain(x, ws, "relu2", b, 128, torch.bfloat16),
                        kd.chain_reference(x, ws, "relu2", b,
                                           torch.bfloat16)))
    for depth in (2, 8):
        x, ws = sc.chain_inputs(rows, torch.int8, dev, seed=13, depth=depth)
        for mode in kd.CHAIN_MODES[torch.int8]:
            want = kd.chain_reference(x, ws, mode)
            for rpb in (64, 128):
                sc.same(f"chain int8 {mode} r{rpb} rows {rows} depth {depth}",
                        kd.chain(x, ws, mode, None, rpb), want)
    n = 1001
    pe, ped = (x.to(torch.bfloat16).contiguous() for x in
               fm.encode_points(net, pts[:n], dirs[:n]))
    for stage in (0, 1, 2):
        err["kdiag2_ladder"] = max(err["kdiag2_ladder"], sc.close(
            f"ladder v{stage} N={n}", kd.ladder(net, pe, ped, stage),
            kd.ladder_reference(net, pe, ped, stage)))
    for S in (64, 192):
        o, d, bc, z = kdiag3.rays(n, S, dev, seed=11)
        pe, ped = kd.encode_rays(net, o, d, z)
        err["kdiag3_render_a"] = max(err["kdiag3_render_a"], sc.close_lanes(
            f"render_a R={n} S={S}", kd.render_probe_a(net, pe, ped, S),
            kd.render_probe_a_reference(net, pe, ped, S)))
        err["kdiag3_render_b"] = max(err["kdiag3_render_b"], sc.close_lanes(
            f"render_b R={n} S={S}", kd.render_probe_b(net, o, d, z),
            kd.render_probe_b_reference(net, o, d, z)))
        with torch.no_grad():
            err["kdiag3_render_c"] = max(
                err["kdiag3_render_c"], kdiag3.close_render(
                    f"render_c R={n} S={S}",
                    fr.fused_render_rays(model, folded, pcfg, o, d, z, bc),
                    fr.fused_render_rays_reference(model, folded, pcfg, o, d,
                                                   z, bc)))
    torch.cuda.synchronize()
    return err


def _chain_bound(rows: int, kind: str, in_bytes: int, out_bytes: int,
                 extra_bytes: int = 0) -> dict:
    """Bound of an 8-layer 256-wide chain on ``rows`` rows: its operations
    at the peak for ``kind``; x read and the output written once, the
    weights (and biases) read once."""
    W, depth = 256, 8
    w_bytes = depth * W * W * {"int8": 1, "bf16": 2, "f32": 4}[kind] \
        + extra_bytes
    return _bound(2.0 * rows * depth * W * W,
                  rows * W * (in_bytes + out_bytes) + w_bytes, kind)


def _worst(results: dict, labels=None) -> float:
    """The largest ``--check`` error over an entry point's kernel variants
    (those in ``labels``); the library variants have no plain version."""
    err = 0.0
    for label, r in results.items():
        if label in ("matmul", "VX", "V3X", "IX") or (
                labels and label not in labels):
            continue
        for v in (r["rows"].values() if "rows" in r else [r]):
            err = max(err, v["max_err"])
    return err


# the probes on the wgmma chain: the bf16 chain's 14 instantiations, the
# ladder's two and probes A and B (mangled-name stems after _ZN2fr)
CHAIN_PROBES = ("2kd10k_chain_wg", "2kd12k_mlp_ladder",
                "2kd16k_render_probe_a", "2kd16k_render_probe_b")
# the f32 chain (FFMA ring) and the int8 chain (s8 wgmma, 2 modes x 2
# plans)
DTYPE_CHAINS = ("2kd16k_chain_f32_ring", "2kd13k_chain_i8_wg")


def _probe_builds(kd, fm, fr, ptxas, so_path, big: int) -> None:
    """Phase 11a': the wgmma probes' and the f32 and int8 chains' ptxas
    lines (a spill fails; a wgmma serialized by ptxas, C7511, fails in
    the probes and the paper width's instances; the other widths' are
    phase 12d's to print), HGMMA counts (none fails), the int8 chain's IGMMA
    and IMMA and the f32 chain's FFMA, HMMA and HGMMA (the int8 chain on
    s8 wgmma, the f32 one on FFMAs alone), probe B's warpgroup
    synchronisations, the chains' plans at ``big`` rows (the f32 and int8
    ones against ``kdiag.chain_plan``), the ladder's (K5's) and probes
    A's and B's beside K1's at 64 and 192 depths."""
    import torch

    from idealnerf_tpu_torch.scripts.harness import sass_counts

    serialized = [ln for ln in ptxas if "C7511" in ln
                  and not any(f"LayoutILi{w}E" in ln for w in WIDTHS)]
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    for i, ln in enumerate(ptxas):
        if any(f"Function properties for _ZN2fr{k}" in ln
               for k in CHAIN_PROBES + DTYPE_CHAINS):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
            if not any("0 bytes spill stores, 0 bytes spill loads" in x
                       for x in ptxas[i + 1:i + 3]):
                raise AssertionError(f"a probe spills: {ln}")
    names = tuple(k[k.index("k_"):] for k in CHAIN_PROBES + DTYPE_CHAINS)
    ops = sass_counts(so_path, names, ("HGMMA", "IGMMA", "IMMA", "HMMA",
                                       "FFMA", "WARPGROUP"))
    hgmma = {k: ops["HGMMA"][k] for k in names[:len(CHAIN_PROBES)]}
    print(f"  HGMMA instructions in the probes' SASS (summed over the "
          f"chain's instantiations): {hgmma}; probe B's WARPGROUP "
          f"synchronisations {ops['WARPGROUP']['k_render_probe_b']}")
    if not all(n > 0 for n in hgmma.values()):
        raise AssertionError(f"a wgmma probe has no HGMMA: {hgmma}")
    f32, i8 = (k[k.index("k_"):] for k in DTYPE_CHAINS)
    print(f"  {i8}: {ops['IGMMA'][i8]} IGMMA (s8 wgmma), {ops['IMMA'][i8]} "
          f"IMMA; {f32}: {ops['FFMA'][f32]} FFMA, {ops['HMMA'][f32]} HMMA, "
          f"{ops['HGMMA'][f32]} HGMMA")
    if not (ops["IGMMA"][i8] > 0 == ops["IMMA"][i8] + ops["HMMA"][i8]):
        raise AssertionError(f"the int8 chain is not on s8 wgmma: {ops}")
    if not (ops["FFMA"][f32] > 0 == ops["HMMA"][f32] + ops["HGMMA"][f32]):
        raise AssertionError(f"the f32 chain runs a tensor-core product: "
                             f"{ops}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for rpb in kd.CHAIN_PLANS[dtype]:
            plan = kd.chain_launch_config(big, rpb, dtype)
            print(f"  chain {str(dtype)[6:]} r{rpb} at {big} rows: {plan}")
            if dtype != torch.bfloat16 and plan != kd.chain_plan(
                    big, rpb, dtype, sms):
                raise AssertionError(f"the {dtype} chain's plan is not "
                                     f"kdiag.chain_plan's: {plan}")
    print(f"  ladder (K5's plan) at {big} points: "
          f"{fm.point_launch_config(big)}")
    for S in (64, 192):
        print(f"  render_a S={S}: {kd.render_probe_launch_config(S, 'a')}, "
              f"render_b: {kd.render_probe_launch_config(S, 'b')} (K1: "
              f"{fr.render_launch_config(S)})")


def _phase_kdiag(fm, fr, pts, dirs, rays: int, big: int = 1 << 21,
                 slope=(1 << 20, 1 << 22), render_lib=None, ptxas=(),
                 so_path=None) -> dict:
    """Phase 11b-c: the wgmma probes' builds and plans (with ``so_path``),
    the ragged probe checks, then each kdiag entry point at its own size
    with ``--check`` (every timed output against its plain version on the
    same inputs, that version timed once), the launch counters set to 0
    before it and read after -> the entries of K5 and the probe kernels by
    name. ``render_lib``: phase 2's torch.addmm yardstick of the fine pass
    at ``rays`` x 192, the render probes' work (their ``library_ms``)."""
    import torch

    from idealnerf_tpu_torch.kernels import kdiag as kd
    from idealnerf_tpu_torch.scripts import (
        kdiag, kdiag2, kdiag3, kdiag4, kdiag5, paper_field,
    )

    dev = pts.device
    if so_path:
        _probe_builds(kd, fm, fr, ptxas, so_path, big)
    model, folded, pcfg, net = probe = paper_field(dev)
    errs = _check_probes(kd, fm, fr, probe, pts, dirs)
    runs, launches = {}, {}
    for name, mod, argv in (
            ("kdiag", kdiag, ["--rows", str(big)]),
            ("kdiag2", kdiag2, ["--rows", str(big)]),
            ("kdiag3", kdiag3, ["--kd3_r", str(rays), "--kd3_s", "64,192"]),
            ("kdiag4", kdiag4, ["--kd4", "V0,V2,V3,V5,V6,V7,VP,VX,V3X",
                                "--kd4_rows", str(slope[0]),
                                "--slope_rows", "%d,%d" % slope]),
            ("kdiag5", kdiag5, ["--slope_rows", "%d,%d" % slope])):
        argv = argv + ["--check"]
        print(f"phase 11 {name}.main({' '.join(argv)})")
        for m in (kd, fm, fr):
            m.reset_launch_counts()
        with torch.no_grad():
            runs[name] = mod.main(argv)["results"]
        torch.cuda.synchronize()
        launches[name] = {**kd.launch_counts, **fm.launch_counts,
                          **fr.launch_counts}
        torch.cuda.empty_cache()

    # the entries' times: the bf16 chains' real pattern at r128 (the plan
    # whose two warpgroups share each weight stage), f32 (V3) at its one
    # plan (128) and int8 (I0) at 64, the faster of its two in kprobe's
    # turns, the ladder's own last rung, K5 as rung v3, the render probes
    # at the fine pass's 192 depths; each beside its plain version's time
    # from the same run
    mid, S = slope[0], 192
    v3, i0 = "V3 r128", "I0 r64"
    pt, ray = _mlp_macs(pcfg)
    # K5's and the ladder's yardsticks on kdiag2's own encodings
    pe, ped = kdiag2.inputs(net, big, dev)[:2]
    k5_lib = _point_library_ms(net, pe, ped)
    v2_lib = _point_library_ms(net, pe, ped, heads=False)
    del pe, ped
    torch.cuda.empty_cache()
    wb = _weight_bytes(pcfg)
    ops = 2.0 * rays * (S * pt + ray)
    raw_bytes = rays * S * 16.0
    k3 = runs["kdiag3"]

    def entry(r, n, bound, err, library, body):
        return {"ms": r["ms"], "plain_ms": r["plain_ms"], "launches": n,
                "library_ms": library, "max_abs_err": err, **bound,
                "body": body}

    chain_body = "wgmma chain (kdiag.cu k_chain_wg on csrc/chain.cuh)"
    v4_bf16 = [lb for lb in runs["kdiag4"] if not lb.startswith("V3")]
    out = {
        "kdiag_chain": entry(
            runs["kdiag"]["relu r128"], launches["kdiag"]["kdiag_chain_bf16"],
            _chain_bound(big, "bf16", 2, 2, 8 * 256 * 4),
            max(errs["kdiag_chain"], _worst(runs["kdiag"])),
            runs["kdiag"]["matmul"]["ms"], chain_body),
        "kdiag4_chain": entry(
            runs["kdiag4"]["V0 r128"]["rows"][str(mid)],
            launches["kdiag4"]["kdiag_chain_bf16"],
            _chain_bound(mid, "bf16", 2, 4),
            max(errs["kdiag4_chain"], _worst(runs["kdiag4"], v4_bf16)),
            runs["kdiag4"]["VX"]["ms"], chain_body),
        "kdiag4_chain_f32": entry(
            runs["kdiag4"][v3]["rows"][str(mid)],
            launches["kdiag4"]["kdiag_chain_f32"],
            _chain_bound(mid, "f32", 4, 4),
            max(errs["kdiag4_chain_f32"],
                _worst(runs["kdiag4"], (v3,))),
            runs["kdiag4"]["V3X"]["ms"],
            f"FFMA ring ({v3}: kdiag_dtype.cu k_chain_f32_ring on "
            "csrc/fring.cuh, K6 f32's product)"),
        "kdiag5_chain": entry(
            runs["kdiag5"][i0]["rows"][str(mid)],
            launches["kdiag5"]["kdiag_chain_int8"]
            + launches["kdiag5"]["kdiag_chain_bf16"],
            _chain_bound(mid, "int8", 1, 4),
            max(errs["kdiag5_chain"], _worst(runs["kdiag5"])),
            runs["kdiag5"]["IX"]["ms"],
            f"s8 wgmma ({i0}: kdiag_dtype.cu k_chain_i8_wg); B0 "
            + chain_body),
        "kdiag2_ladder": entry(
            runs["kdiag2"]["v2"], launches["kdiag2"]["kdiag_ladder"],
            _bound(2.0 * big * kd.ladder_macs(net, 2),
                   big * 2.0 * (fr.PE_PAD + fr.PED_PAD + 128) + wb),
            max(errs["kdiag2_ladder"],
                _worst(runs["kdiag2"], ("v0", "v1", "v2"))), v2_lib,
            "wgmma chain (K5's, csrc/chain.cuh ActivationTile)"),
        "fused_point_mlp_pe": entry(
            runs["kdiag2"]["v3"], launches["kdiag2"]["fused_point_mlp_pe"],
            _bound(2.0 * big * (pt + ray),
                   wb + big * (2.0 * (fr.PE_PAD + fr.PED_PAD) + 16)),
            _worst(runs["kdiag2"], ("v3",)), k5_lib, "wgmma chain (K5)"),
        "kdiag3_render_a": entry(
            k3[f"A S={S}"], launches["kdiag3"]["kdiag_render_a"],
            _bound(ops, rays * (S * 2.0 * fr.PE_PAD + 2.0 * fr.PED_PAD)
                   + raw_bytes + wb),
            max(errs["kdiag3_render_a"], _worst(k3, ("A S=64", "A S=192"))),
            render_lib, "wgmma chain (K1's, csrc/chain.cuh PeRayTile)"),
        "kdiag3_render_b": entry(
            k3[f"B S={S}"], launches["kdiag3"]["kdiag_render_b"],
            _bound(ops, rays * (24.0 + 4.0 * S) + raw_bytes + wb),
            max(errs["kdiag3_render_b"], _worst(k3, ("B S=64", "B S=192"))),
            render_lib, "wgmma chain (K1's, csrc/chain.cuh RayTile)"),
        "kdiag3_render_c": entry(
            k3[f"C S={S}"], launches["kdiag3"]["fused_render_rays"],
            _ray_bound(pcfg, rays, S, 9 + S, 8 + S),
            max(errs["kdiag3_render_c"], _worst(k3, ("C S=64", "C S=192"))),
            render_lib, "wgmma chain (K1)"),
    }
    for k, e in out.items():
        print(f"  {k}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms"
              + (f", library {e['library_ms']:.3f} ms"
                 if e["library_ms"] is not None else "")
              + f", bound {e['bound_ms']:.3f} ms by {e['bound_by']}, "
              f"launches {e['launches']}, max error {e['max_abs_err']:.3e}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"entries": out, "runs": runs, "launches": launches}


def _phase_kframe() -> list:
    """Phase 11d: scripts.kframe on a whole 450x450 frame, the coarse and
    fine kernels through their wrappers and alone at other launch plans;
    every plan's outputs bitwise equal to the wrapper's and each worker's
    launch counters equal to its wrapper calls."""
    import torch

    from idealnerf_tpu_torch.scripts import kframe

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("phase 11 kframe.main()")
    res = kframe.main([])
    if not res["ok"]:
        raise AssertionError("kframe: a plan's outputs differ from the "
                             "wrapper's or a launch count from its calls")
    return res["results"]


def _phase_kpoint() -> list:
    """Phase 11e: scripts.kpoint, K4 and K5 through their wrappers and
    alone at other launch plans; every plan's output bitwise equal to the
    wrapper's and each worker's launch counters equal to its wrapper
    calls."""
    import torch

    from idealnerf_tpu_torch.scripts import kpoint

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("phase 11 kpoint.main()")
    res = kpoint.main([])
    if not res["ok"]:
        raise AssertionError("kpoint: a plan's output differs from the "
                             "wrapper's or a launch count from its calls")
    return res["results"]


def _step_ms(step, n: int, windows: int = 3) -> list:
    """ms per training step: ``step(i)`` n times in each of ``windows``
    wall windows after two warm-up steps, each window opened and closed by
    a device synchronize, so it spans every step's host and device work
    -> the windows' ms per step (their spread is the call's)."""
    import torch

    for i in range(2):
        step(i)
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / n)
    return out


def _profile_train_step(args, train_fused: int = 2, phase: str = "8"):
    """The phase-8 configuration's ms per step at ``train_fused``
    (``_step_ms``: 3 windows of 18 steps on a fresh trainer) and one warm
    step, profiled."""
    import torch

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.head import HeadTrainer

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           train_fused=train_fused)
    ds = make_synthetic_dataset(n_frames=2, H=args.train_hw, W=args.train_hw,
                                dim_expr=76)
    tr = HeadTrainer(cfg, ds, seed=0, device="cuda")
    step = tr._step_fn(smooth=False)
    ms = _step_ms(lambda i: step(tr.state, tr.data, i % ds.size,
                                 tr.generator), 18)
    print(f"phase {phase} train step (train_fused {train_fused}): "
          f"{sorted(ms)[1]:.2f} ms/step, the median of 3 windows of 18 "
          f"steps (each {', '.join(f'{m:.2f}' for m in ms)})")
    fname = ("profile_train_step.txt" if train_fused == 2 and phase == "8"
             else f"profile_train_step_fused{train_fused}.txt")
    prof = _profile(lambda: step(tr.state, tr.data, 0, tr.generator),
                    f"training step ({args.train_hw}x{args.train_hw}, "
                    f"N_rand 2048, 64+128, train_fused {train_fused})", fname)
    del tr, step
    torch.cuda.empty_cache()
    return {**prof, "step_ms": sorted(ms)[1], "step_ms_windows": ms}


def _torso_setup(cfg, dev, seed: int = 5):
    """Seeded torso nets at the paper width on ``dev`` and their config."""
    import torch

    from idealnerf_tpu_torch.train.torso import (
        init_torso_params, torso_nerf_config,
    )

    return (init_torso_params(cfg, torch.Generator().manual_seed(seed))
            .to(dev), torso_nerf_config(cfg))


def _phase_torso_field(fr, cfg, nets, cond, ds, sizes) -> dict:
    """Phase 12a: the torso field (D=8, W=256, dim_aud 32 + 42) through K2
    and K1 at each size of ``sizes`` (rays cast from the first frame's
    pose) against the plain versions; a 24x24 composite frame on the card
    against the plain versions on the host; the composite 450x450 frame's
    ms beside the head frame's (CUDA events)."""
    import torch

    from idealnerf_tpu_torch.core.sampling import stratified_sample
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.renderer import (
        make_composite_frame_renderer, make_frame_renderer,
    )
    from idealnerf_tpu_torch.models.face_nerf import fold_conditioning
    from idealnerf_tpu_torch.train.state import init_params
    from idealnerf_tpu_torch.train.torso import torso_signal

    aud, expr, latent = cond
    dev = aud.device
    torso, tcfg = _torso_setup(cfg, dev)
    pose0 = torch.from_numpy(ds.poses[0]).to(dev)
    signal = torso_signal(aud, pose0, cfg.dim_aud_body)
    fc, ff = (fold_conditioning(torso[k], tcfg, signal)
              for k in ("coarse", "fine"))
    near, far, n_s, n_i = ds.near, ds.far, cfg.N_samples, cfg.N_importance
    errs = {"fused_render_coarse_hier": 0.0, "fused_render_rays": 0.0}
    print(f"phase 12a torso field (D={tcfg.depth}, W={tcfg.width}, dim_aud "
          f"{cfg.dim_aud_body} + 42) through K2 + K1 vs plain versions")
    keys = ("rgb_map", "acc_map", "last_weight")
    for tag, (o, d, b) in sizes.items():
        R = o.shape[0]
        c_args = (torso["coarse"], fc, tcfg, o, d, b, near, far, n_s, n_i)
        ck, zk = fr.fused_render_coarse_hier(*c_args)
        cp, _ = fr.fused_render_coarse_hier_reference(*c_args)
        print(f"  R={R} ({tag}), {n_s}+{n_i}:")
        e = [_agree(f"coarse {k}", ck[k], cp[k], corr=k == "rgb_map")
             for k in keys]
        zc = stratified_sample(near, far, n_s, R, device=dev)
        e.append(_agree("fine depths vs plain merge of the kernel's weights",
                        zk, fr.importance_depths(zc, ck["weights"], n_i),
                        atol=Z_ATOL))
        errs["fused_render_coarse_hier"] = max(
            errs["fused_render_coarse_hier"], *e)
        f_args = (torso["fine"], ff, tcfg, o, d, zk, b)
        fk, fp = fr.fused_render_rays(*f_args), fr.fused_render_rays_reference(
            *f_args)
        e = [_agree(f"fine {k}", fk[k], fp[k], corr=k == "rgb_map")
             for k in keys]
        errs["fused_render_rays"] = max(errs["fused_render_rays"], *e)
        del ck, zk, cp, fk, fp
        torch.cuda.empty_cache()

    # a small composite frame, card against the plain versions on the host
    st = init_params(cfg, 1, torch.Generator().manual_seed(6))
    tp, _ = _torso_setup(cfg, "cpu", seed=7)
    sds = make_synthetic_dataset(n_frames=2, H=24, W=24, dim_expr=76,
                                 with_torso=True)
    small = make_composite_frame_renderer(
        cfg.face_nerf_config(), tcfg, 24, 24, sds.focal, sds.near, sds.far,
        cfg.render_config(), cx=sds.cx, cy=sds.cy)
    a = torch.randn(64, generator=torch.Generator().manual_seed(8))
    frames = {}
    for d in ("cpu", dev):
        hp, tq = st.params.to(d), tp.to(d)
        pose = torch.from_numpy(sds.poses[1]).to(d)
        frames[d] = small(hp, tq, pose, torch.from_numpy(sds.poses[0]).to(d),
                          torch.from_numpy(sds.bc_img).to(d).float() / 255,
                          aud=a.to(d), signal=torso_signal(a.to(d), pose, 32),
                          expr=torch.from_numpy(sds.exprs[1]).to(d),
                          latent=torch.ones(32, device=d))
    print("  24x24 composite frame, card vs plain versions on the host:")
    err24 = _agree("composite frame", frames[dev].cpu(), frames["cpu"],
                   corr=True)

    H, W = ds.hw
    bc = torch.from_numpy(ds.bc_img).to(dev).float() / 255
    view = (H, W, ds.focal, near, far, cfg.render_config())
    comp = make_composite_frame_renderer(cfg.face_nerf_config(), tcfg, *view,
                                         cx=ds.cx, cy=ds.cy)
    head = make_frame_renderer(cfg.face_nerf_config(), *view, cx=ds.cx,
                               cy=ds.cy)
    ms = {"composite": _time_ms(lambda: comp(
              nets, torso, pose0, pose0, bc, aud=aud, signal=signal,
              expr=expr, latent=latent), 3),
          "head": _time_ms(lambda: head(nets, pose0, bc, aud=aud, expr=expr,
                                        latent=latent), 3)}
    print(f"  {H}x{W} frame at {n_s}+{n_i}: composite {ms['composite']:.1f} "
          f"ms, head alone {ms['head']:.1f} ms (CUDA events, 3 frames each "
          "after a warm-up)")
    torch.cuda.synchronize()
    return {"errs": errs, "frame_24_err": err24, "frame_ms": ms}


def _phase_torso_train(args, fm, fmg, head_ckpt: str, rays: int = 2048,
                       dev: str = "cuda") -> dict:
    """Phase 12b: one torso step with ``train_fused 2`` against
    ``train_fused 0`` on the same coords (no random draws): the loss within
    GRAD_TOL["bf16"]["plain"] relative, each torso gradient within
    GRAD_TOL["bf16"]["autograd"] norm-relative (phase 7's bf16 bounds) and
    with a correlation above 1 - tol^2 / 2 (what that distance allows at
    equal norms); then cli.train_torso.main on the phase-8 head checkpoint
    for train_epochs x train_frames steps: finite loss and PSNR, K4
    launched 4 times a step and the gradient kernel twice, the head
    bitwise unchanged, a checkpoint at the last step; then on a fresh
    trainer the ms per step (``_step_ms``: 3 windows of all but two
    warm-up steps) and a profiled step."""
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import train_torso
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.sampler import sample_ray_coords
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.state import init_params
    from idealnerf_tpu_torch.train.torso import (
        TorsoTrainer, make_torso_frame_loss, torso_ray_budget,
    )

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           N_rand=rays)
    H = W = args.train_hw
    ds = make_synthetic_dataset(n_frames=args.train_frames, H=H, W=W,
                                dim_expr=76, with_torso=True)
    ck = CheckpointManager(head_ckpt).restore()
    head = init_params(cfg, ds.size).params
    head.load_state_dict(ck["params"])
    head, latent = head.to(dev), ck["latent_codes"].to(dev)
    data = ds.to_device(dev)
    torso, _ = _torso_setup(cfg, dev)
    budget, rect, box = torso_ray_budget(cfg, H, W, dev)
    coords = sample_ray_coords(
        torch.Generator(device=dev).manual_seed(1), H, W, rect, box,
        torch.zeros((H, W), dtype=torch.uint8, device=dev), budget)
    loss, grads = {}, {}
    for tf in (2, 0):
        c = dataclasses.replace(cfg, train_fused=tf)
        torso.zero_grad(set_to_none=True)
        out, _ = make_torso_frame_loss(c, ds, True, dev)(
            torso, head, latent, data, 1, coords, None)
        out.backward()
        loss[tf] = float(out.detach())
        grads[tf] = {n: p.grad.detach().clone()
                     for n, p in torso.named_parameters()}
    tol, ltol = GRAD_TOL["bf16"]["autograd"], GRAD_TOL["bf16"]["plain"]
    min_corr = 1.0 - tol ** 2 / 2
    lerr = abs(loss[2] - loss[0]) / abs(loss[0])
    worst, low = (0.0, ""), (1.0, "")
    for n, g in grads[2].items():
        r = grads[0][n]
        worst = max(worst, (_norm_rel(g, r), n))
        if g.numel() > 1:  # a one-element bias has no correlation
            low = min(low, (float(torch.corrcoef(torch.stack(
                [g.reshape(-1).double(), r.reshape(-1).double()]))[0, 1]),
                n))
    print(f"phase 12b torso step, train_fused 2 vs 0 ({budget.total} rays at "
          f"{H}x{W}, no draws): loss {loss[2]:.6f} vs {loss[0]:.6f} "
          f"(relative {lerr:.2e}, tol {ltol:g}); worst gradient "
          f"norm-relative {worst[0]:.3e} ({worst[1]}; tol {tol:g}), lowest "
          f"correlation {low[0]:.6f} ({low[1]}; > {min_corr:.5f})")
    if not (lerr <= ltol and worst[0] <= tol and low[0] > min_corr):
        raise AssertionError("the fused torso step disagrees with the plain")
    del grads, torso, data
    torch.cuda.empty_cache()

    steps = args.train_epochs * args.train_frames
    shutil.rmtree("output/chip_smoke_torso", ignore_errors=True)  # no resume
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_torso.main([
        "--synthetic", str(args.train_frames), "--synthetic_hw", str(H),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--N_rand", str(rays), "--N_samples", "64", "--N_importance", "128",
        "--steps", str(steps), "--i_print", "5", "--device", dev,
        "--basedir", "output/chip_smoke_torso", "--head_ckpt", head_ckpt])
    counts = {"fused_point_mlp": fm.launch_counts["fused_point_mlp"],
              **fmg.launch_counts}
    hist = res["history"]
    first, last = hist[0][1], hist[-1][1]
    print(f"  train_torso: {res['step']} steps on {args.train_frames} frames "
          f"of {H}x{W}, D=8 W=256 N_rand {rays} 64+128; loss "
          f"{first['loss']:.5f} -> {last['loss']:.5f}, PSNR "
          f"{first['psnr']:.3f} -> {last['psnr']:.3f}; launches {counts}")
    if not all(math.isfinite(m[k]) for _, m in hist for k in ("loss",
                                                              "psnr")):
        raise AssertionError("train_torso produced a non-finite loss or PSNR")
    want = {"fused_point_mlp": 4 * steps, "fused_point_mlp_grad": 2 * steps}
    if res["step"] != steps or {k: counts[k] for k in want} != want:
        raise AssertionError(f"train_torso launched {counts}, want {want}")
    moved = [k for k, v in res["head_params"].state_dict().items()
             if not torch.equal(v.cpu(), ck["params"][k])]
    print(f"  head parameters bitwise unchanged: {not moved}")
    if moved:
        raise AssertionError(f"train_torso moved the frozen head: {moved}")
    if CheckpointManager(res["ckpt_dir"]).latest_step() != steps:
        raise AssertionError(f"no torso checkpoint at step {steps}")

    tr = TorsoTrainer(cfg, ds, res["head_params"], latent, seed=2,
                      device=dev)
    ms = _step_ms(lambda i: tr._step_fn(tr.state, tr.head_params,
                                        tr.latent_codes, tr.data,
                                        i % ds.size, tr.generator),
                  steps - 2)
    step_ms = sorted(ms)[1]
    print(f"  torso step: {step_ms:.2f} ms/step, the median of 3 windows of "
          f"{steps - 2} steps (each {', '.join(f'{m:.2f}' for m in ms)})")
    prof = _profile(lambda: tr._step_fn(tr.state, tr.head_params,
                                        tr.latent_codes, tr.data, 0,
                                        tr.generator),
                    f"torso step ({H}x{W}, N_rand {rays}, 64+128)",
                    "profile_torso_step.txt")
    torch.cuda.synchronize()
    return {"steps": steps, "step_ms": step_ms, "step_ms_windows": ms,
            "first": first, "last": last,
            "launches": counts, "ckpt_dir": res["ckpt_dir"],
            "fused_vs_plain": {"loss_rel": lerr, "worst": worst,
                               "lowest_corr": low},
            "profile": prof}


def _phase_reenact(args, fr, head_ckpt: str, torso_ckpt: str,
                   dev: str = "cuda") -> dict:
    """Phase 12c: cli.eval_reenact.main --torso_ckpt: composite frames of
    450x450 from the phase-8 head and the 12b torso; finite frames (a
    non-finite pixel makes the PSNR non-finite), K2 and K1 launched twice
    a frame (head, torso)."""
    from idealnerf_tpu_torch.cli import eval_reenact

    n = args.frames
    fr.reset_launch_counts()
    res = eval_reenact.main([
        "--synthetic", str(n), "--synthetic_hw", str(args.hw), "--dim_aud",
        "64", "--dim_expr", "76", "--dim_latent", "32", "--device", dev,
        "--head_ckpt", head_ckpt, "--torso_ckpt", torso_ckpt,
        "--save_path", "output/chip_smoke_reenact"])
    counts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                               "fused_render_rays")}
    print(f"phase 12c eval_reenact --torso_ckpt: {res['frames']} composite "
          f"frames of {args.hw}x{args.hw}, {res['frame_ms']:.1f} ms/frame "
          f"after the first, PSNR {res['psnr']:.3f} against the com frames; "
          f"launches {counts}")
    if not math.isfinite(res["psnr"]) or res["frames"] != n:
        raise AssertionError("eval_reenact produced non-finite frames")
    if counts != dict.fromkeys(counts, 2 * n):
        raise AssertionError(f"eval_reenact launched {counts} for {n} frames")
    frame0 = res.pop("video")[0]  # the report keeps the metrics only
    return {**res, "launches": counts, "frame0": frame0}


def _leaves(tree):
    """The tensors of a nested dict / tuple cache, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def _phase_temporal_composite(args, fr, head_ckpt: str, torso_ckpt: str,
                              frame0, dev: str = "cuda",
                              hw: int = 450) -> dict:
    """Phase 12e: the temporal head + torso composite from the phase-8
    head and the 12b torso on the 450x450 subject of phases 9-10. (a) K3
    on the torso field (the torso prior's rays from the first pose) and K1
    on a freeze_z delta frame's kept rays against their plain versions;
    (b) cli.serve.main --torso_ckpt at the serving defaults, then --roll_k
    4, with the live launches asserted; (c) cli.eval_reenact.main
    --torso_ckpt --temporal 5 --prior 1 in four modes with their launches,
    --cycle 0 bitwise equal to --cycle 1, render.cycle bitwise per-frame
    calls, and a run without --prior whose keyframe is phase 12c's
    composite frame (2e-5)."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import eval_reenact, serve
    from idealnerf_tpu_torch.cli.common import load_torso
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.core.rays import get_rays
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.renderer import foreground_prior_fields
    from idealnerf_tpu_torch.eval.temporal import (
        _prior_sel, make_temporal_composite_renderer,
    )
    from idealnerf_tpu_torch.models.face_nerf import fold_conditioning
    from idealnerf_tpu_torch.train.state import init_params
    from idealnerf_tpu_torch.train.torso import (
        torso_nerf_config, torso_signal,
    )

    t0 = time.perf_counter()
    K1, K2, K3 = ("fused_render_rays", "fused_render_coarse_hier",
                  "fused_render_delta")
    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32)
    tcfg = torso_nerf_config(cfg)
    n_s, n_i = cfg.N_samples, cfg.N_importance
    n_frames = args.serve_frames
    sds = make_synthetic_dataset(n_frames=n_frames, H=hw, W=hw, dim_expr=76)
    near, far = sds.near, sds.far
    mh, mt = foreground_prior_fields(sds)
    sel_h, sel_t = _prior_sel(mh, hw * hw), _prior_sel(mt, hw * hw)
    torso = load_torso(torso_ckpt, cfg, dev)
    pose0 = torch.from_numpy(sds.poses[0]).to(dev)
    signal = torso_signal(torch.randn(64, generator=torch.Generator()
                                      .manual_seed(9)).to(dev), pose0,
                          cfg.dim_aud_body)

    def fold(net, c):
        return fold_conditioning(net, c, signal)

    o, d = (x.reshape(-1, 3) for x in get_rays(hw, hw, sds.focal, pose0,
                                               sds.cx, sds.cy))
    bc = (torch.from_numpy(sds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    st = torch.from_numpy(sel_t).long().to(dev)
    ro, rd, rb = (x[st].contiguous() for x in (o, d, bc))
    print(f"phase 12e temporal composite: priors of the {hw}x{hw} subject: "
          f"head {int(mh.sum())} px -> {len(sel_h)} rays, torso "
          f"{int(mt.sum())} px -> {len(sel_t)} rays, union "
          f"{int((mh | mt).sum())} px")
    errs = {K3: max(_delta_case(fr, torso, fold, tcfg, ro, rd, rb, near,
                                far, n_s, n_i, s, f"torso, s_delta {s}")
                    for s in (16, 32))}

    # K1 on a freeze_z delta frame's kept rays: the keyframe's own grid
    render = make_temporal_composite_renderer(
        cfg.face_nerf_config(), tcfg, hw, hw, sds.focal, near, far,
        cfg.render_config(), cx=sds.cx, cy=sds.cy, prior_mask_head=mh,
        prior_mask_torso=mt, s_delta=16, freeze_z_torso=True,
        delta_keep_torso=0.01)
    field = render.stages["torso"]
    if field.uses_delta_kernel:
        raise AssertionError("a freeze_z field would launch the delta kernel")
    ff = fold(torso["fine"], tcfg)
    e = []
    with torch.no_grad():
        _, _, _, cache = field(torso, pose0, bc.reshape(hw, hw, 3),
                               (signal, None, None), None)
        keep = cache["keep"]
        z_all = _delta_keyframe(fr, torso, fold, tcfg, ro, rd, rb, near, far,
                                n_s, n_i)[0]
        for tag, rays in (
                ("all torso rays", (ro, rd, z_all, rb)),
                ("kept rays, delta_keep 0.01",
                 (ro[keep].contiguous(), rd[keep].contiguous(), cache["z"],
                  rb[keep].contiguous()))):
            a = (torso["fine"], ff, tcfg, *rays)
            k, p = fr.fused_render_rays(*a), fr.fused_render_rays_reference(*a)
            print(f"  fused_render_rays on a freeze_z torso delta frame "
                  f"[{tag}, R={rays[0].shape[0]}, S={rays[2].shape[1]}]:")
            e += [_agree(key, k[key], p[key], corr=key == "rgb_map")
                  for key in ("rgb_map", "acc_map", "weights", "last_weight")]
    errs[K1] = max(e)
    del o, d, bc, ro, rd, rb, z_all, cache, render, field
    torch.cuda.empty_cache()

    dims = ["--synthetic", str(n_frames), "--synthetic_hw", str(hw),
            "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
            "--device", dev, "--head_ckpt", head_ckpt, "--torso_ckpt",
            torso_ckpt]
    out = {"errs": errs, "rays": {"head": len(sel_h), "torso": len(sel_t)}}
    for tag, extra, warm in (("defaults", [], WARMUP_COMP),
                             ("roll_k 4", ["--roll_k", "4", "--max_frames",
                                           "10"], WARMUP_COMP_ROLL)):
        fr.reset_launch_counts()
        stats = serve.main(dims + extra)
        counts = dict(fr.launch_counts)
        live = {k: counts[k] - warm[k] for k in warm}
        n = stats["frames"]
        if extra:
            want = {K2: 2 * n, K1: 2 * n, K3: 2 * (n - 1)}
        else:
            want = {K2: 2 * stats["keyframes"], K1: 2 * stats["keyframes"],
                    K3: 2 * stats["delta_frames"]}
        print(f"  serve --torso_ckpt [{tag}]: {n} frames, "
              f"{stats['keyframes']} keyframes + {stats['delta_frames']} "
              f"delta frames; launches {counts} (live {live}, want {want}); "
              f"keyframe {stats['keyframe_ms']} ms, delta p50 "
              f"{stats['delta_p50_ms']} ms, p95 {stats['delta_p95_ms']} ms; "
              f"steady frames p50 {stats['p50_ms']:.2f}, p95 "
              f"{stats['p95_ms']:.2f}, p99 {stats['p99_ms']:.2f} ms, "
              f"{stats['steady_fps']:.2f} fps, 40 ms hit rate "
              f"{stats['deadline_40ms_hit_rate']:.3f}, warm-up "
              f"{stats['warmup_s']:.2f} s")
        if not stats["finite"]:
            raise AssertionError(f"composite serve [{tag}] emitted a "
                                 "non-finite frame")
        if live != want:
            raise AssertionError(f"composite serve [{tag}] launched {live}, "
                                 f"want {want}")
        out[f"serve {tag}"] = {"stats": stats, "launches": counts}

    reen = dims + ["--temporal", "5", "--prior", "1", "--max_frames", "10",
                   "--save_path", "output/chip_smoke_temporal"]
    n = min(10, n_frames)
    kf = -(-n // 5)
    dl = n - kf
    modes = {
        "cycle 1": ([], {K2: 2 * kf, K1: 2 * kf, K3: 2 * dl}),
        "cycle 0": (["--cycle", "0"], {K2: 2 * kf, K1: 2 * kf, K3: 2 * dl}),
        "freeze_z_torso": (["--freeze_z_torso", "1", "--delta_keep_torso",
                            "0.01"], {K2: 2 * kf, K1: 2 * kf + dl, K3: dl}),
        "roll_k_torso 4": (["--roll_k_torso", "4"],
                           {K2: 2 * kf + dl, K1: 2 * kf + dl, K3: dl}),
    }
    videos = {}
    for tag, (extra, want) in modes.items():
        fr.reset_launch_counts()
        res = eval_reenact.main(reen + extra)
        counts = {k: fr.launch_counts[k] for k in want}
        videos[tag] = res.pop("video")
        print(f"  eval_reenact --temporal 5 --prior 1 [{tag}]: "
              f"{res['frames']} frames, {res['frame_ms']:.2f} ms/frame after "
              f"the first, PSNR {res['psnr']:.3f}; launches {counts} (want "
              f"{want})")
        if not (math.isfinite(res["psnr"]) and res["frames"] == n):
            raise AssertionError(f"eval_reenact [{tag}] produced non-finite "
                                 "frames")
        if counts != want:
            raise AssertionError(f"eval_reenact [{tag}] launched {counts}, "
                                 f"want {want}")
        out[f"reenact {tag}"] = {**res, "launches": counts}
    if not np.array_equal(videos["cycle 1"], videos["cycle 0"]):
        raise AssertionError("--cycle 1 frames differ from --cycle 0's")
    print("  --cycle 1 frames bitwise equal to --cycle 0's (both run the "
          "per-frame loop)")

    # render.cycle on the card, with the richest cache (pruned, kf_blend):
    # its frames and final cache bitwise those of per-frame calls
    head = init_params(cfg, n_frames).params
    ck = CheckpointManager(head_ckpt).restore()
    head.load_state_dict(ck["params"])
    head = head.to(dev)
    render = make_temporal_composite_renderer(
        cfg.face_nerf_config(), tcfg, hw, hw, sds.focal, near, far,
        cfg.render_config(), cx=sds.cx, cy=sds.cy, prior_mask_head=mh,
        prior_mask_torso=mt, s_delta=16, delta_keep_head=0.5,
        delta_keep_torso=0.5, kf_blend=0.5)
    g = torch.Generator().manual_seed(11)
    T = 3
    poses = torch.from_numpy(sds.poses[1:T + 2]).to(dev)
    auds, exprs = (torch.randn(T + 1, k, generator=g).to(dev)
                   for k in (64, 76))
    sigs = torch.stack([torso_signal(a, pose0, cfg.dim_aud_body)
                        for a in auds])
    latent = ck["latent_codes"][0].to(dev)
    bc_img = torch.from_numpy(sds.bc_img).to(dev).float() / 255.0
    with torch.no_grad():
        def frame(t, cache):
            return render(head, torso, poses[t], pose0, bc_img, aud=auds[t],
                          signal=sigs[t], expr=exprs[t], latent=latent,
                          cache=cache)
        _, c0 = frame(0, None)
        _, c1 = frame(1, c0)
        loop, c = [], c1
        for t in range(2, T + 1):
            f, c = frame(t, c)
            loop.append(f)
        cyc, c_cyc = render.cycle(
            head, torso, poses[2:], pose0, bc_img, c1, auds=auds[2:],
            signals=sigs[2:], exprs=exprs[2:],
            latents=latent[None].expand(T - 1, -1))
    la, lb = _leaves(c_cyc), _leaves(c)
    same = (torch.equal(cyc, torch.stack(loop)) and len(la) == len(lb) > 0
            and all(torch.equal(a, b) for a, b in zip(la, lb)))
    print(f"  render.cycle over {T - 1} delta frames (pruned 0.5, kf_blend "
          f"0.5): frames and cache bitwise the per-frame calls': {same}")
    if not same:
        raise AssertionError("render.cycle differs from per-frame calls")
    del head, render, c0, c1, c, c_cyc, cyc, loop
    torch.cuda.empty_cache()

    res = eval_reenact.main([
        "--synthetic", str(args.frames), "--synthetic_hw", str(args.hw),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--device", dev, "--head_ckpt", head_ckpt, "--torso_ckpt", torso_ckpt,
        "--temporal", "5", "--max_frames", "1"])
    err = float(np.abs(res["video"][0] - frame0).max())
    print(f"  eval_reenact --temporal 5 without --prior: keyframe against "
          f"phase 12c's composite frame, max abs {err:.3g} (bound 2e-5)")
    if not err <= 2e-5:
        raise AssertionError("the temporal keyframe is not the composite "
                             "frame")
    out["keyframe_err"] = err
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 12e took {out['seconds']:.1f} s")
    torch.cuda.synchronize()
    return out


# phase 12d: the widths besides the paper's that the kernels are built at
# (ROADMAP.md B10), their check sizes, and the frame of render_val's
# card-against-host comparison (a W=512 frame on the host's cores)
WIDTHS = (128, 512)
WIDTH_RAYS, WIDTH_POINTS, WIDTH_PASS_A_POINTS = 8192, 524288, 65536
WIDTH_HOST_HW = 32
# the kernels' entries in the kernels line at each width, and their
# wrapper's launch count
WIDTH_KERNELS = ("fused_render_coarse_hier", "fused_render_rays",
                 "fused_render_delta", "fused_point_mlp",
                 "fused_point_mlp_pe", "fused_point_mlp_grad",
                 "grad_pass_a_f32", "grad_pass_b_f32")


def _width_nets(W: int, dev: str, seed: int):
    """The paper model (D=8, dim_aud 64, dim_expr 76, dim_latent 32) at
    width W: (cfg, ncfg, coarse and fine FaceNeRFs, folding function), the
    weights and conditioning drawn from ``seed``."""
    import torch

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.models.face_nerf import (
        FaceNeRF, fold_conditioning,
    )

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           netwidth=W)
    ncfg = cfg.face_nerf_config()
    gen = torch.Generator().manual_seed(seed)
    nets = {k: FaceNeRF(ncfg, gen).to(dev) for k in ("coarse", "fine")}
    cond = (torch.randn(64, generator=gen).to(dev),
            torch.randn(76, generator=gen).to(dev),
            torch.ones(32, device=dev))

    def fold(net, c):
        with torch.no_grad():
            return fold_conditioning(net, c, *cond)

    return cfg, ncfg, nets, cond, fold


def _width_rays(dev: str, rays: int):
    """``rays`` rays spread over a 450x450 frame of the synthetic subject
    and its near/far: (rays_o, rays_d, plate, near, far)."""
    import torch

    from idealnerf_tpu_torch.core.rays import get_rays
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(n_frames=1, H=450, W=450, dim_expr=76)
    ro, rd = get_rays(450, 450, ds.focal,
                      torch.from_numpy(ds.poses[0]).to(dev), ds.cx, ds.cy)
    bc = (torch.from_numpy(ds.bc_img).to(dev).float() / 255.0)
    pick = torch.linspace(0, 450 * 450 - 1, rays).long().to(dev)
    ro, rd, bc = (x.reshape(-1, 3)[pick].contiguous() for x in (ro, rd, bc))
    return ro, rd, bc, ds.near, ds.far


def _width_timed(name, run, plain, bound, launches, err, out):
    """The kernel's time (CUDA events, after a warm-up) beside its plain
    version's and the bound, into out[name]."""
    ms, pms = _time_ms(run, 3), _time_ms(plain, 1)
    out[name] = {"ms": ms, "plain_ms": pms, **bound, "max_abs_err": err,
                 "launches": launches}
    print(f"  {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms by {bound['bound_by']} "
          f"({100 * bound['bound_ms'] / ms:.1f} % of it; CUDA events)")


def _repeats(name, a, b) -> None:
    """Two launches' outputs (tensors, or dicts and tuples of them)
    bitwise equal, or raise."""
    import torch

    def flat(x):
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in flat(y)]
        return [x]

    same = all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    print(f"  {name}: two launches bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{name} is not repeatable")


def _width_kernels(fr, fm, fmg, W: int, dev: str = "cuda",
                   rays: int = WIDTH_RAYS,
                   points: int = WIDTH_POINTS,
                   pass_a_points: int = WIDTH_PASS_A_POINTS) -> dict:
    """K1-K6 at width W against their plain versions, each timed beside
    them with its bound: K2 and K1 at ``rays`` rays of a 450x450 frame (64
    + 128 depths), K3 from their keyframe (s_delta 16, then from its own
    output), K4 and K5 at ``points`` points, the bf16 and f32 backwards
    (K6) there too, repeated bitwise, and K6's pass A alone (bf16, f32)
    against its plain version at ``pass_a_points`` (the f64 planes of its
    check at W=512 fill a card at ``points``) -> {kernel: its numbers}."""
    import torch

    from idealnerf_tpu_torch.core.sampling import stratified_sample
    from idealnerf_tpu_torch.kernels.fused_render import (
        model_leaves, pack_leaves,
    )

    cfg, ncfg, nets, cond, fold = _width_nets(W, dev, seed=W)
    ro, rd, bc, near, far = _width_rays(dev, rays)
    n_s, n_i = cfg.N_samples, cfg.N_importance
    S = n_s + n_i
    fc, ff = fold(nets["coarse"], ncfg), fold(nets["fine"], ncfg)
    out = {}
    print(f" W={W}, D={ncfg.depth}: {rays} rays ({n_s}+{n_i}), {points} "
          "points; plans: " + "; ".join(
              f"{k} " + _plan_text(fr.render_launch_config(*a, width=W))
              for k, a in (("K2", (n_s, n_i)), ("K1", (S,)))))
    c_args = (nets["coarse"], fc, ncfg, ro, rd, bc, near, far, n_s, n_i)
    ck, zk = fr.fused_render_coarse_hier(*c_args)
    _repeats(f"W={W} K2", (ck, zk), fr.fused_render_coarse_hier(*c_args))
    cp, _ = fr.fused_render_coarse_hier_reference(*c_args)
    keys = ("rgb_map", "acc_map", "weights", "last_weight")
    e = [_agree(f"W={W} K2 {k}", ck[k], cp[k], corr=k == "rgb_map")
         for k in keys]
    zc = stratified_sample(near, far, n_s, rays, device=dev)
    e.append(_agree(f"W={W} K2 z_all vs plain merge of the kernel's "
                    "weights", zk, fr.importance_depths(
                        zc, ck["weights"], n_i), atol=Z_ATOL))
    _width_timed("fused_render_coarse_hier",
                 lambda: fr.fused_render_coarse_hier(*c_args),
                 lambda: fr.fused_render_coarse_hier_reference(*c_args),
                 _ray_bound(ncfg, rays, n_s, 9, 8 + n_s + S), None, max(e),
                 out)
    f_args = (nets["fine"], ff, ncfg, ro, rd, zk, bc)
    fk, fp = fr.fused_render_rays(*f_args), fr.fused_render_rays_reference(
        *f_args)
    _repeats(f"W={W} K1", fk, fr.fused_render_rays(*f_args))
    e = [_agree(f"W={W} K1 {k}", fk[k], fp[k], corr=k == "rgb_map")
         for k in keys]
    _width_timed("fused_render_rays", lambda: fr.fused_render_rays(*f_args),
                 lambda: fr.fused_render_rays_reference(*f_args),
                 _ray_bound(ncfg, rays, S, 9 + S, 8 + S), None, max(e), out)
    del ck, cp, fk, fp

    err3 = _delta_case(fr, nets, fold, ncfg, ro, rd, bc, near, far, n_s,
                       n_i, 16, f"W={W}")
    s_uni, s_imp = _delta_split(16)
    z, w = _delta_keyframe(fr, nets, fold, ncfg, ro, rd, bc, near, far, n_s,
                           n_i)
    lo, hi = _delta_band(z, w, near, far)
    d_args = (nets["fine"], ff, ncfg, ro, rd, z, w, lo, hi, bc, far, s_uni,
              s_imp)
    _width_timed("fused_render_delta", lambda: fr.fused_render_delta(*d_args),
                 lambda: fr.fused_render_delta_reference(*d_args),
                 _ray_bound(ncfg, rays, s_uni + s_imp + 1,
                            9 + 2 * z.shape[1] + 2, 8 + 2 * (s_uni + s_imp
                                                             + 1)),
                 None, err3, out)
    del z, w, lo, hi
    torch.cuda.empty_cache()

    pts, dirs = _points(ro, rd, near, far, points)
    packed = fr.pack_operands(nets["fine"], ff, ncfg)
    got, want = fm.point_mlp(packed, pts, dirs), fm.point_mlp_reference(
        packed, pts, dirs)
    _repeats(f"W={W} K4", got, fm.point_mlp(packed, pts, dirs))
    err4 = _agree(f"W={W} K4 raw", got, want, corr=True)
    _width_timed("fused_point_mlp", lambda: fm.point_mlp(packed, pts, dirs),
                 lambda: fm.point_mlp_reference(packed, pts, dirs),
                 _point_bound(ncfg, points, False), None, err4, out)
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(packed, pts, dirs))
    got = fm.point_mlp_pe(packed, pe, ped)
    err5 = _agree(f"W={W} K5 raw", got, fm.point_mlp_pe_reference(
        packed, pe, ped), corr=True)
    _width_timed("fused_point_mlp_pe",
                 lambda: fm.point_mlp_pe(packed, pe, ped),
                 lambda: fm.point_mlp_pe_reference(packed, pe, ped),
                 _point_bound(ncfg, points, False), None, err5, out)
    del got, want, pe, ped
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(W + 1)
    g = (torch.randn(points, 4, generator=gen, device=dev) / 64).contiguous()
    for tag, gd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        f32 = tag == "f32"
        with torch.no_grad():
            leaves = model_leaves(nets["coarse"], fc, ncfg)
            pk = pack_leaves(ncfg, leaves, gd)
        a = fmg.point_mlp_grad(pk, pts, dirs, g)
        b = fmg.point_mlp_grad(pk, pts, dirs, g)
        same = all(torch.equal(x, y) for x, y in zip(_packed_list(a),
                                                      _packed_list(b)))
        del b
        tol = GRAD_TOL[tag]["plain"]
        ref = _plain_on_kernel_forward(fmg, pk, pts, dirs, g, f32)
        rel = {name: _norm_rel(x, r) for name, x, r in zip(
            _packed_names(pk), _packed_list(a), _packed_list(ref))}
        err = max(float((x - r).abs().max())
                  for x, r in zip(_packed_list(a), _packed_list(ref)))
        worst = max((e, k) for k, e in rel.items())
        del ref
        torch.cuda.empty_cache()
        own = fmg.point_mlp_grad_reference(pk, pts, dirs, g)
        apart = max((_norm_rel(x, r), k) for k, x, r in zip(
            _packed_names(pk), _packed_list(a), _packed_list(own)))
        del own
        print(f"  W={W} K6 {tag} N={points}: worst norm-relative error vs "
              f"the plain backward on the kernel's forward {worst[0]:.3e} "
              f"({worst[1]}; tol {tol:g}); vs the plain backward on its own "
              f"forward {apart[0]:.3e} ({apart[1]}; relu' decisions apart, "
              f"not bounded); two launches bitwise equal: {same}")
        n_a = pass_a_points
        p_a, d_a, g_a = pts[:n_a], dirs[:n_a], g[:n_a].contiguous()
        exact = fmg.grad_pass_b_reference(pk, fmg.grad_pass_a_reference(
            pk, p_a, d_a, g_a, torch.float64))
        mine = fmg.point_mlp_grad(pk, p_a, d_a, g_a)
        plain = fmg.point_mlp_grad_reference(pk, p_a, d_a, g_a)
        print(f"  N={n_a}, each operand's distance from f64 sums at the "
              "same rounding points, kernel / plain version: " + ", ".join(
                  f"{k} {_norm_rel(x.double(), e):.2e}/"
                  f"{_norm_rel(y.double(), e):.2e}" for k, x, y, e in zip(
                      _packed_names(pk), _packed_list(mine),
                      _packed_list(plain), _packed_list(exact))))
        del exact, mine, plain
        if not worst[0] <= tol:
            print("  per operand: " + ", ".join(
                f"{k} {e:.2e}" for k, e in rel.items()))
            _pass_a_diag(fmg, pk, p_a, d_a, g_a, f32)
            raise AssertionError(f"W={W} {tag} gradients disagree")
        if not same:
            raise AssertionError(f"W={W} {tag} gradients are not repeatable")
        del a
        torch.cuda.empty_cache()
        _check_pass_a(fmg, pk, p_a, d_a, g_a, f32=f32)
        torch.cuda.empty_cache()
        bound = _point_bound(ncfg, points, True, tag,
                             _plane_bytes(fmg, pk, points, f32))
        if not f32:
            _width_timed("fused_point_mlp_grad",
                         lambda: fmg.point_mlp_grad(pk, pts, dirs, g),
                         lambda: fmg.point_mlp_grad_reference(pk, pts, dirs,
                                                              g),
                         bound, None, err, out)
        else:
            ba, bb = _pass_bounds(fmg, ncfg, pk, points, f32=True)
            bufs = {}
            _width_timed("grad_pass_a_f32",
                         lambda: bufs.update(a=fmg.grad_pass_a(pk, pts, dirs,
                                                               g)),
                         lambda: fmg.grad_pass_a_reference(pk, pts, dirs, g),
                         ba, None, err, out)
            _width_timed("grad_pass_b_f32",
                         lambda: fmg.grad_pass_b(pk, *bufs["a"]),
                         lambda: fmg.grad_pass_b_reference(
                             pk, fmg.buffers_from_planes_f32(
                                 pk, *bufs["a"], points)),
                         bb, None, err, out)
            del bufs
        torch.cuda.empty_cache()
    del pts, dirs, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _plain_on_kernel_forward(fmg, packed, pts, dirs, g, f32: bool):
    """The plain backward (the two passes' plain versions) on the
    kernel's own pass A activations: the relu' decisions are the
    kernel's, so the two backwards differ only by their sums' order and
    not by a d_h element flipped whole where an activation rounds to 0 in
    one forward and not in the other. The forward itself is held to f64
    by _check_pass_a."""
    planes, offs, bias = fmg.grad_pass_a(packed, pts, dirs, g)
    own = (fmg.buffers_from_planes_f32 if f32 else fmg.buffers_from_planes)(
        packed, planes, offs, bias, pts.shape[0])
    del planes
    return fmg.grad_pass_b_reference(packed, fmg.grad_pass_a_reference(
        packed, pts, dirs, g, forward=own))


def _pass_a_diag(fmg, packed, pts, dirs, g, f32: bool) -> None:
    """Where a backward's pass A departs from its plain version: every
    plane's and the bias rows' norm-relative distance, printed."""
    planes, offs, bias = fmg.grad_pass_a(packed, pts, dirs, g)
    got = (fmg.buffers_from_planes_f32 if f32 else fmg.buffers_from_planes)(
        packed, planes, offs, bias, pts.shape[0])
    want = fmg.grad_pass_a_reference(packed, pts, dirs, g)
    rows = [("pe", got.pe, want.pe), ("ped", got.ped, want.ped),
            ("gb", got.gb, want.gb), ("bias", got.bias, want.bias)]
    for key in ("hs", "hvs", "dcs", "dvs"):
        rows += [(f"{key[:-1]}{j}", x, y) for j, (x, y) in enumerate(
            zip(getattr(got, key), getattr(want, key)))]
    print("  pass A planes vs plain: " + ", ".join(
        f"{k} {_norm_rel(x, y):.2e}" for k, x, y in rows))


def _phase_widths(fr, fm, fmg, ptxas, dev: str = "cuda",
                  host_hw: int = WIDTH_HOST_HW,
                  keep_going: bool = False) -> dict:
    """Phase 12d (ROADMAP.md B10): the paper model at W=128 and W=512 on
    the kernels' own instances of those widths. For each width: K1-K6
    against their plain versions and timed (_width_kernels); then a head
    trained by train_head on the card (2 frames of 450x450, 2 epochs) and
    render_val of its checkpoint: one 450x450 frame on the card, and one
    frame of host_hw on the card and on the host, agreeing within 3e-2,
    corr > 0.999; K1, K2, K4 and K6 must have launched on the card (the
    counts per width). Then a net wider than the widest instance (W=1024)
    is refused by both entry points before any launch, naming B10. With
    ``keep_going`` a width whose checks fail does not stop the others;
    the phase fails at its end."""
    import torch

    from idealnerf_tpu_torch.cli import render_val, train_head

    t0 = time.perf_counter()
    kernels = (fr, fm, fmg)

    def launches():
        return {k: v for m in kernels for k, v in m.launch_counts.items()
                if v}

    def reset():
        for k in kernels:
            k.reset_launch_counts()

    print("phase 12d B10: the paper model at W=128 and W=512 on the "
          "kernels' own instances")
    for ln in ptxas:  # the other widths' wgmma that ptxas serialized
        if "C7511" in ln and any(f"LayoutILi{w}E" in ln for w in WIDTHS):
            print("  ptxas serialized: " + ln[ln.index("function"):])
    for i, ln in enumerate(ptxas):  # every instance's registers, spills
        if "Function properties for _ZN2fr" in ln and "LayoutILi" in ln:
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
            if not any("0 bytes spill stores, 0 bytes spill loads" in x
                       for x in ptxas[i:i + 3]) and "LayoutILi256" in ln:
                raise AssertionError(f"a W=256 instance spills: {ln}")
    base = ["--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
            "--N_samples", "64", "--N_importance", "128"]
    out = {"widths": {}}
    failed = []
    for W in WIDTHS:
        reset()
        try:
            res = _width_kernels(fr, fm, fmg, W, dev)
        except AssertionError as e:
            if not keep_going:
                raise
            print(f"  W={W} FAILED: {e}")
            failed.append(f"W={W}: {e}")
            torch.cuda.empty_cache()
            continue
        net = ["--netwidth", str(W), "--netdepth", "8"]
        d = f"output/chip_smoke_widths/w{W}"
        shutil.rmtree(d, ignore_errors=True)
        reset()
        tr = train_head.main([*base, *net, "--synthetic", "2",
                              "--synthetic_hw", "450", "--N_rand", "2048",
                              "--epochs", "2", "--i_print", "1", "--device",
                              dev, "--basedir", d])
        last = tr["history"][-1][1]
        if not math.isfinite(last["loss"]):
            raise AssertionError(f"W={W}: train_head is non-finite")
        frames = {}
        for tag, device, hw in (("card 450", dev, 450),
                                ("card", dev, host_hw),
                                ("host", "cpu", host_hw)):
            rv = render_val.main([*base, *net, "--synthetic", "1",
                                  "--synthetic_hw", str(hw), "--max_frames",
                                  "1", "--device", device, "--head_ckpt",
                                  tr["ckpt_dir"], "--save_path",
                                  f"{d}/{tag.replace(' ', '_')}"])
            if not math.isfinite(rv["psnr"]):
                raise AssertionError(f"W={W}: render_val on {tag} is "
                                     "non-finite")
            frames[tag] = (torch.from_numpy(rv["frames"]), rv)
        counts = launches()
        want = {"fused_render_coarse_hier": 2, "fused_render_rays": 2,
                "fused_point_mlp": 2 * tr["step"],
                "fused_point_mlp_grad": 2 * tr["step"]}
        print(f"  W={W}: train_head {tr['step']} steps, loss "
              f"{last['loss']:.5f}; render_val 450x450 "
              f"{frames['card 450'][1]['frame_ms']:.1f} ms a frame; "
              f"launches {counts}")
        if any(counts.get(k) != n for k, n in want.items()):
            raise AssertionError(f"W={W} launched {counts}, want {want}")
        err = _agree(f"W={W} frames of one checkpoint, card vs host",
                     frames["card"][0], frames["host"][0], corr=True)
        for k, n in counts.items():
            if k in res:
                res[k]["launches"] = n
        out["widths"][str(W)] = {
            "kernels": res, "launches": counts, "frame_err": err,
            "train_steps": tr["step"], "loss": last["loss"],
            "frame_ms_450": frames["card 450"][1]["frame_ms"]}
        del frames
        torch.cuda.empty_cache()
    wide = ["--netwidth", "1024", "--netdepth", "4"]
    reset()
    for name, run in (
            ("train_head", lambda: train_head.main(
                [*base, *wide, "--synthetic", "2", "--synthetic_hw", "64",
                 "--N_rand", "1024", "--epochs", "1", "--device", dev,
                 "--basedir", "output/chip_smoke_widths/w1024"])),
            ("render_val", lambda: render_val.main(
                [*base, *wide, "--synthetic", "2", "--synthetic_hw", "64",
                 "--max_frames", "1", "--device", dev, "--save_path",
                 "output/chip_smoke_widths/w1024"]))):
        try:
            run()
        except ValueError as e:
            print(f"  W=1024 {name} refused: {e}")
            if "B10" not in str(e):
                raise
        else:
            raise AssertionError(f"W=1024 {name} ran on the card")
    if launches():
        raise AssertionError(f"W=1024 launched {launches()}")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 12d took {out['seconds']:.1f} s")
    if failed:
        raise AssertionError(f"phase 12d failed: {failed}")
    return out


PAPER_FLAGS = ["--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
               "--N_samples", "64", "--N_importance", "128"]
# the head CLIs' metric records: train_head's keys (the JAX CLI's)
HEAD_KEYS = {"step", "time"} | {f"train/{k}" for k in (
    "loss", "psnr", "latent_loss", "lr", "steps_per_sec",
    "steps_per_sec_rolling")}
JPEG_MAE = 6.0     # levels: an image through one JPEG round trip


def _jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _avi_check(path: str, frames, tag: str) -> dict:
    """The .avi at ``path`` and its first still hold ``frames`` (n, H, W,
    3) in [0, 1] within JPEG error, at 25 fps."""
    import numpy as np

    from idealnerf_tpu_torch.eval.video import read_avi_frames

    video, fps = read_avi_frames(path)
    still = os.path.splitext(path)[0] + "_00000.jpg"
    mae = float(np.abs(video.astype(np.float32)
                       - 255.0 * np.asarray(frames)).mean()) if len(
                           video) == len(frames) else float("inf")
    print(f"  {tag}: {path} holds {len(video)} frames at {fps:g} fps, mean "
          f"abs error {mae:.3f} levels against the returned frames (< "
          f"{JPEG_MAE:g}); still {os.path.basename(still)} "
          f"{os.path.exists(still)}")
    if not (len(video) == len(frames) and fps == 25.0 and mae < JPEG_MAE
            and os.path.exists(still)):
        raise AssertionError(f"{tag}: the .avi does not hold the frames")
    return {"path": path, "frames": len(video), "fps": fps, "mae": mae}


def _phase_subject_io(root: str, hw: int, n_frames: int) -> dict:
    """Phase 13a: the JPEG route, the synthetic subject written through the
    port's export and read back by its loader, and the I/O rates."""
    import numpy as np

    from idealnerf_tpu_torch import native
    from idealnerf_tpu_torch.data import jpeg
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.data.export import write_reference_format
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.video import VideoWriter

    t0 = time.perf_counter()
    native.load_library()
    png_build_s = time.perf_counter() - t0
    print(f"phase 13a JPEG route: {jpeg.library_version()}; PNG row filters "
          f"native (g++ build {png_build_s:.2f} s)")
    ds = make_synthetic_dataset(n_frames=n_frames, H=hw, W=hw, dim_expr=76,
                                with_torso=True)
    subj = os.path.join(root, "subject")
    t0 = time.perf_counter()
    cfg_path = write_reference_format(ds, subj, subject="subject")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = load_transforms_dataset(subj, mode="train")
    load_s = time.perf_counter() - t0
    val = load_transforms_dataset(subj, mode="val", gt_dirs="com_imgs")
    split = int(n_frames * 10 / 11)
    img_err = float(np.abs(train.images.astype(np.int16)
                           - ds.images[:split].astype(np.int16)).mean())
    ok = (train.size == split and val.size == n_frames - split
          and np.allclose(train.poses, ds.poses[:split], atol=1e-5)
          and np.allclose(train.exprs, ds.exprs[:split], atol=1e-5)
          and np.allclose(train.landmarks, ds.landmarks[:split], atol=0.01)
          and np.array_equal(train.auds, ds.auds)
          and np.allclose(val.poses, ds.poses[split:], atol=1e-5)
          and img_err < JPEG_MAE)
    paths = [os.path.join(subj, "head_imgs", f"{i}.jpg")
             for i in range(n_frames)]
    decode = []
    for _ in range(3):
        t0 = time.perf_counter()
        jpeg.decode_jpeg_batch(paths, hw, hw)
        decode.append(1e3 * (time.perf_counter() - t0) / n_frames)
    avi = os.path.join(root, "frames.avi")
    t0 = time.perf_counter()
    with VideoWriter(avi, frame_jpg_every=10) as w:
        for f in ds.images:
            w.add(f)
    avi_ms = 1e3 * (time.perf_counter() - t0) / n_frames
    res = {"route": jpeg.library_version(), "png_build_s": png_build_s,
           "write_s": write_s, "load_s": load_s,
           "decode_ms_per_frame": sorted(decode)[1],
           "decode_ms_runs": decode, "avi_write_ms_per_frame": avi_ms,
           "train": train.size, "val": val.size, "image_mae": img_err,
           "config": cfg_path}
    print(f"  {n_frames} frames of {hw}x{hw} with torso written in "
          f"{write_s:.3f} s to {subj}; train split ({train.size} frames) "
          f"loaded in {load_s:.3f} s, val {val.size}; poses, exprs, "
          f"landmarks, audio round trip {ok}, image mean abs error "
          f"{img_err:.3f} levels; decode {res['decode_ms_per_frame']:.3f} "
          f"ms/frame (median of 3 batches of {n_frames}: "
          f"{', '.join(f'{d:.3f}' for d in decode)}); .avi write "
          f"{avi_ms:.3f} ms/frame")
    if not ok:
        raise AssertionError("the subject does not round-trip through the "
                             "export and the loader")
    res["avi"] = _avi_check(avi, ds.images / 255.0, "13a frames.avi")
    return res


def _phase_subject(args, fm, fmg, fr, dev: str = "cuda", hw: int = 450,
                   n_frames: int = 8, rays: int = 2048) -> dict:
    """Phase 13: the real-subject path. 13a ``_phase_subject_io``; 13b
    train_head.main on the subject directory (paper model, 2 epochs), K4
    and K6 twice a step, its metrics.jsonl read back; 13c train_torso.main
    on the subject's com_imgs, 5 steps, torso/ records; 13d render_val.main
    writes <expname>_val.avi, held against the frames it returns, K2/K1
    once a frame; 13e eval_reenact.main --torso_ckpt and serve.main, each
    .avi with the right frame count, launches as phases 12c and 10."""
    from idealnerf_tpu_torch.cli import (
        eval_reenact, render_val, serve, train_head, train_torso,
    )
    from idealnerf_tpu_torch.eval.video import read_avi_frames

    root = "output/chip_smoke_subject"
    shutil.rmtree(root, ignore_errors=True)   # no resume, no stale videos
    res = {"io": _phase_subject_io(root, hw, n_frames)}
    cfg_path = res["io"]["config"]
    logs, out = os.path.join(root, "logs"), os.path.join(root, "video")
    base = ["--config", cfg_path, *PAPER_FLAGS, "--device", dev,
            "--basedir", logs]

    # 13b: the head
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    i_print = 5
    th = train_head.main([*base, "--N_rand", str(rays), "--epochs", "2",
                          "--i_print", str(i_print)])
    steps = th["step"]
    counts, want = _train_launches(fm, fmg, steps)
    recs = _jsonl(os.path.join(logs, "subject_head", "metrics.jsonl"))
    good = ([r["step"] for r in recs] == list(range(i_print, steps + 1,
                                                    i_print))
            and all(set(r) == HEAD_KEYS for r in recs)
            and all(math.isfinite(v) for r in recs for v in r.values()))
    print(f"phase 13b train_head --datadir: {steps} steps, D=8 W=256 N_rand "
          f"{rays} 64+128; launches {counts}; metrics.jsonl {len(recs)} "
          f"records at steps {[r['step'] for r in recs]}, keys as the JAX "
          f"CLI's and finite: {good}; loss {recs[-1]['train/loss']:.5f}, "
          f"PSNR {recs[-1]['train/psnr']:.3f}")
    if counts != want or not good:
        raise AssertionError(f"train_head on the subject: launches {counts} "
                             f"for {steps} steps, records ok {good}")
    res["train_head"] = {"steps": steps, "launches": counts,
                         "records": len(recs), "last": recs[-1],
                         "ckpt_dir": th["ckpt_dir"]}

    # 13c: the torso on the subject's com_imgs
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    tt = train_torso.main([*base, "--N_rand", str(rays), "--steps", "5",
                           "--i_print", "2", "--head_ckpt", th["ckpt_dir"]])
    tcounts = {"fused_point_mlp": fm.launch_counts["fused_point_mlp"],
               **fmg.launch_counts}
    trecs = _jsonl(os.path.join(logs, "subject_head_torso", "metrics.jsonl"))
    want = {"fused_point_mlp": 20, "fused_point_mlp_grad": 10}
    good = ([r["step"] for r in trecs] == [0, 2, 4]
            and all({"torso/loss", "torso/psnr", "torso/lr"} <= set(r)
                    for r in trecs)
            and all(math.isfinite(v) for r in trecs for v in r.values()))
    print(f"phase 13c train_torso --datadir (com_imgs): {tt['step']} steps; "
          f"launches {tcounts}; metrics.jsonl torso/ records at steps "
          f"{[r['step'] for r in trecs]}, finite: {good}")
    if {k: tcounts[k] for k in want} != want or not good:
        raise AssertionError(f"train_torso on the subject: launches "
                             f"{tcounts}, want {want}; records ok {good}")
    res["train_torso"] = {"steps": tt["step"], "launches": tcounts,
                          "records": len(trecs), "ckpt_dir": tt["ckpt_dir"]}

    # 13d: the val split to <expname>_val.avi
    fr.reset_launch_counts()
    rv = render_val.main([*base, "--head_ckpt", th["ckpt_dir"],
                          "--save_path", out])
    n = len(rv["frames"])
    rcounts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                                "fused_render_rays")}
    print(f"phase 13d render_val --datadir: {n} val frames, PSNR "
          f"{rv['psnr']:.3f}, {rv['frame_ms']:.1f} ms/frame; launches "
          f"{rcounts}")
    if rcounts != dict.fromkeys(rcounts, n) or not math.isfinite(rv["psnr"]):
        raise AssertionError(f"render_val on the subject launched {rcounts} "
                             f"for {n} frames")
    res["render_val"] = {"frames": n, "psnr": rv["psnr"], "launches": rcounts,
                         "avi": _avi_check(os.path.join(
                             out, "subject_head_val.avi"), rv["frames"],
                             "13d render_val")}

    # 13e: the composite reenactment and the stream, from the directory
    fr.reset_launch_counts()
    n = 3
    rr = eval_reenact.main([*base, "--head_ckpt", th["ckpt_dir"],
                            "--torso_ckpt", tt["ckpt_dir"], "--max_frames",
                            str(n), "--save_path", out])
    ecounts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                                "fused_render_rays")}
    print(f"phase 13e eval_reenact --datadir --torso_ckpt: {rr['frames']} "
          f"composite frames, {rr['frame_ms']:.1f} ms/frame, PSNR "
          f"{rr['psnr']:.3f}; launches {ecounts}")
    if ecounts != dict.fromkeys(ecounts, 2 * n) or rr["frames"] != n:
        raise AssertionError(f"eval_reenact on the subject launched "
                             f"{ecounts} for {n} frames")
    res["reenact"] = {"frames": n, "psnr": rr["psnr"], "launches": ecounts,
                      "avi": _avi_check(os.path.join(out, "subject_head.avi"),
                                        rr["video"], "13e eval_reenact")}
    fr.reset_launch_counts()
    stats = serve.main([*base, "--head_ckpt", th["ckpt_dir"], "--save_path",
                        out])
    scounts = dict(fr.launch_counts)
    live = {k: scounts[k] - WARMUP[k] for k in WARMUP}
    want = {"fused_render_coarse_hier": stats["keyframes"],
            "fused_render_rays": stats["keyframes"],
            "fused_render_delta": stats["delta_frames"]}
    frames = len(read_avi_frames(os.path.join(out,
                                              "subject_head_stream.avi"))[0])
    print(f"  serve --datadir: {stats['frames']} frames ({stats['keyframes']}"
          f" keyframes + {stats['delta_frames']} delta), p50 "
          f"{stats['p50_ms']:.2f} ms; launches {scounts} (live {live}, want "
          f"{want}); subject_head_stream.avi holds {frames} frames")
    if live != want or not stats["finite"] or frames != stats["frames"]:
        raise AssertionError(f"serve on the subject: live launches {live}, "
                             f"want {want}; {frames} frames in the .avi")
    res["serve"] = {"stats": stats, "launches": scounts, "avi_frames": frames}
    return res


def _phase_fixture(fr, dev: str = "cuda",
                   stem: str = "tests/fixtures/jax_frame_450") -> dict:
    """Phase 13f: the paper model drawn from the fixture's seed
    (``bridge.seeded_tree``) renders the synthetic subject's frame 0
    through K2 + K1, held against the JAX package's plain XLA frame
    committed as an 8-bit PNG (3e-2, correlation > 0.999)."""
    import torch

    from idealnerf_tpu_torch import bridge
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.renderer import make_frame_renderer
    from idealnerf_tpu_torch.eval.video import read_png

    with open(stem + ".json") as fh:
        meta = json.load(fh)
    cfg = ExperimentConfig(**meta["config"])
    hw, subj = meta["hw"], meta["subject"]
    params = bridge.params_from_jax(bridge.seeded_tree(cfg, meta["seed"]),
                                    cfg, device=dev)
    cond = {k: torch.from_numpy(v).to(dev) for k, v in
            bridge.seeded_conditioning(cfg, meta["seed"]).items()}
    ds = make_synthetic_dataset(n_frames=subj["n_frames"], H=hw, W=hw,
                                dim_expr=cfg.dim_expr,
                                with_torso=subj["with_torso"])
    render = make_frame_renderer(cfg.face_nerf_config(), hw, hw, ds.focal,
                                 ds.near, ds.far, cfg.render_config(),
                                 cx=ds.cx, cy=ds.cy)
    fr.reset_launch_counts()
    frame = render(params, torch.from_numpy(ds.poses[subj["frame"]]).to(dev),
                   torch.from_numpy(ds.bc_img).to(dev).float() / 255.0,
                   **cond)
    counts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                               "fused_render_rays")}
    ref = torch.from_numpy(read_png(stem + ".png")).float() / 255.0
    print(f"phase 13f {hw}x{hw} frame (seeded paper model) vs the JAX "
          f"package's plain XLA frame ({stem}.png); launches {counts}")
    err = _agree("frame vs the JAX fixture", frame.float().cpu(), ref,
                 corr=True)
    if counts != dict.fromkeys(counts, 1):
        raise AssertionError(f"the fixture frame launched {counts}")
    return {"max_abs_err": err, "launches": counts}


K1, K2 = "fused_render_rays", "fused_render_coarse_hier"
FAST_KEEP = 0.4   # the fine share of the fast modes (--pruned 40, --fast 40)


@contextlib.contextmanager
def _plain_kernels():
    """The K1/K2 wrappers replaced by their plain versions wherever they
    are looked up: the names eval/renderer.py imports (the fast and pruned
    renderers) and kernels/fused_render.py's own (``render_rays_fused``,
    the full frame). The block must launch neither kernel."""
    from idealnerf_tpu_torch.eval import renderer
    from idealnerf_tpu_torch.kernels import fused_render as fr

    plain = {K1: fr.fused_render_rays_reference,
             K2: fr.fused_render_coarse_hier_reference}
    saved = [(m, k, getattr(m, k)) for m in (renderer, fr) for k in plain]
    before = _frame_launches(fr)
    try:
        for m, k, _ in saved:
            setattr(m, k, plain[k])
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    if _frame_launches(fr) != before:
        raise AssertionError(f"the plain run launched kernels: "
                             f"{before} -> {_frame_launches(fr)}")


def _frame_launches(fr) -> dict:
    return {k: fr.launch_counts[k] for k in (K2, K1)}


def _psnr(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-20))


def _hold_keep_all(tag: str, got, full, coarse_only: int) -> dict:
    """A keep-1.0 frame against the full-fidelity frame: 3e-2 and corr >
    0.999 on every pixel but the ``coarse_only`` rays the fine budget's
    rounding leaves coarse (the JAX package's k = max(k - k % 256, 256):
    202,496 of 450x450's 202,500 rays), which show the coarse composite
    and may sit farther off; they are counted and their error shown."""
    import torch

    err = (got.float() - full.float()).abs().reshape(-1, 3).amax(-1)
    off = int((err > ATOL).sum())
    rest = float(torch.sort(err).values[:err.numel() - coarse_only].max())
    c = float(torch.corrcoef(torch.stack([got.reshape(-1).float(),
                                          full.reshape(-1).float()]))[0, 1])
    print(f"  {tag} vs the full-fidelity frame: max abs {rest:.3e} over all "
          f"but the {coarse_only} coarse-only rays (tol {ATOL:g}); {off} "
          f"pixels over it, max {float(err.max()):.3e}; corr {c:.6f} (> "
          f"{MIN_CORR})")
    if off > coarse_only or rest > ATOL or not c > MIN_CORR:
        raise AssertionError(f"{tag} disagrees with the full-fidelity frame")
    return {"full_err": rest, "pixels_off": off, "corr": c}


def _fast_frame(fr, tag: str, render, call, want: dict, full,
                coarse_only) -> dict:
    """One fast renderer's frame: its launches (``want`` a frame), the same
    path on the plain versions held to 3e-2 with corr > 0.999, the
    full-fidelity frame ``full`` held to the same bar but on
    ``coarse_only`` rays (keep 1.0, ``_hold_keep_all``; None: measured
    against it, max abs error and PSNR), and its ms per frame by CUDA
    events over 3 calls after one."""
    import torch

    args, kw = call
    fr.reset_launch_counts()
    got = render(*args, **kw)
    launches = _frame_launches(fr)
    if launches != want:
        raise AssertionError(f"{tag}: launched {launches} for one frame, "
                             f"want {want}")
    with _plain_kernels():
        plain = render(*args, **kw)
    res = {"launches": launches,
           "plain_err": _agree(f"{tag} vs its plain version", got, plain,
                               corr=True)}
    if coarse_only is not None:
        res.update(_hold_keep_all(tag, got, full, coarse_only))
    else:
        res.update(full_max_abs=float((got - full).abs().max()),
                   psnr_vs_full=_psnr(got, full))
    res["ms"] = _time_ms(lambda: render(*args, **kw), 3)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: non-finite frame")
    print(f"  {tag}: {res['ms']:.2f} ms/frame, launches a frame {launches}"
          + ("" if coarse_only is not None else
             f"; against the full frame max abs {res['full_max_abs']:.4f}, "
             f"PSNR {res['psnr_vs_full']:.2f} dB"))
    return res


def _no_probe():
    raise AssertionError("the cache ran its probe although it holds the "
                         "answer")


def _ragged_rays(fr, n: int) -> int:
    """The most rays up to ``n`` that fill neither K1's (192 depths) nor
    K2's (64 + 128) ray groups exactly: a ragged last group in both."""
    groups = (fr.render_launch_config(192)["rays_per_group"],
              fr.render_launch_config(64, 128)["rays_per_group"])
    while any(n % g == 0 for g in groups):
        n -= 1
    return n


def _phase_ragged(fr, params, ncfg, cond, sds, pose, mask, near, far,
                  dev: str) -> dict:
    """Phase 14c: K2 then K1 on a ragged count of the prior's rays (no
    padding to 256) against their plain versions."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.core.rays import get_rays
    from idealnerf_tpu_torch.core.sampling import stratified_sample
    from idealnerf_tpu_torch.models.face_nerf import fold_conditioning

    hw = mask.shape[0]
    sel = np.nonzero(mask.reshape(-1))[0]
    sel = torch.from_numpy(sel[:_ragged_rays(fr, len(sel))]).to(dev)
    o, d = get_rays(hw, hw, sds.focal, pose, sds.cx, sds.cy)
    bc = (torch.from_numpy(sds.bc_img).to(dev).float() / 255.0)
    o, d, b = (x.reshape(-1, 3)[sel].contiguous() for x in (o, d, bc))
    fc, ff = (fold_conditioning(params[k], ncfg, *cond)
              for k in ("coarse", "fine"))
    r = len(sel)
    print(f"  ragged: K2 then K1 on {r} of the prior's rays (seeded head)")
    ck, zk = fr.fused_render_coarse_hier(params["coarse"], fc, ncfg, o, d, b,
                                         near, far, 64, 128)
    cp, _ = fr.fused_render_coarse_hier_reference(params["coarse"], fc, ncfg,
                                                  o, d, b, near, far, 64, 128)
    e2 = [_agree(f"K2 {k}, R={r}", ck[k], cp[k], corr=k == "rgb_map")
          for k in ("rgb_map", "acc_map", "weights", "last_weight")]
    zc = stratified_sample(near, far, 64, r, device=o.device)
    e2.append(_agree(f"K2 z_all, R={r}", zk, fr.importance_depths(
        zc, ck["weights"], 128), atol=Z_ATOL))
    fk = fr.fused_render_rays(params["fine"], ff, ncfg, o, d, zk, b)
    fp = fr.fused_render_rays_reference(params["fine"], ff, ncfg, o, d, zk, b)
    e1 = [_agree(f"K1 {k}, R={r}", fk[k], fp[k], corr=k == "rgb_map")
          for k in ("rgb_map", "acc_map", "weights", "last_weight")]
    return {"rays": r, "errs": {K2: max(e2), K1: max(e1)}}


def _foreground_share(frame_outputs) -> float:
    """The share of a frame's rays with foreground mass above 0.5."""
    fg = frame_outputs["acc_map"] - frame_outputs["last_weight"]
    return float((fg > 0.5).float().mean())


def _phase_fast(args, fr, head_ckpt: str, torso_ckpt: str, subject: dict,
                dev: str = "cuda", hw: int = 450) -> dict:
    """Phase 14: the per-frame fast modes and the depth-band probes at the
    paper width, on phase 8's head and phase 12b's torso (the checkpoint
    pair) and on seeded random nets (a field with mass on every ray, where
    a short training run may have emptied the checkpoint's), on the
    synthetic subject, then the CLIs on phase 13's subject directory. 14c
    (run first: 14b takes its bands), on the checkpoint pair:
    subject_depth_range and torso_depth_range with their seconds,
    cached_depth_band and cached_occupancy_prior read back without a
    probe, field_occupancy_prior, and a ragged ray count through K2 and K1
    (seeded head). 14a: make_pruned_frame_renderer at keep 0.4 and 1.0,
    prior-masked, and prior-masked with the occupancy cut (K1 2 a frame,
    K2 0; an empty cut is the plate, no launch). 14b:
    make_composite_fast_renderer with per-field priors and bounds and at
    keep 1.0 (K2 2, K1 2 a frame). Each frame against the same path on the
    plain versions (3e-2, corr > 0.999), keep 1.0 also against the
    full-fidelity frame. 14d: ``_phase_fast_clis``."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli.common import load_head, load_torso
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval import renderer as er
    from idealnerf_tpu_torch.train.head import compute_aud_feature
    from idealnerf_tpu_torch.train.state import init_params
    from idealnerf_tpu_torch.train.torso import (
        torso_nerf_config, torso_signal,
    )

    t_phase = time.perf_counter()
    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32)
    ncfg, tcfg, rcfg = (cfg.face_nerf_config(), torso_nerf_config(cfg),
                        cfg.render_config())
    sds = make_synthetic_dataset(n_frames=args.train_frames, H=hw, W=hw,
                                 dim_expr=76, with_torso=True)
    near, far = sds.near, sds.far
    state = load_head(argparse.Namespace(head_ckpt=head_ckpt, seed=0), cfg,
                      sds.size)
    seeded = init_params(cfg, sds.size, torch.Generator().manual_seed(1))
    pairs = {
        "checkpoint": (state.params.to(dev),
                       state.latent_codes.detach().to(dev),
                       load_torso(torso_ckpt, cfg, dev)),
        "seeded": (seeded.params.to(dev), seeded.latent_codes.detach().to(
            dev), _torso_setup(cfg, dev)[0])}
    data = {k: torch.from_numpy(np.asarray(getattr(sds, k))).to(dev)
            for k in ("auds", "aud_ids", "exprs", "poses", "bc_img")}
    bc = data["bc_img"].float() / 255.0
    pose, pose0 = data["poses"][1], data["poses"][0]
    view = (hw, hw, sds.focal, near, far, rcfg)
    where = dict(cx=sds.cx, cy=sds.cy)

    def cond(params, i):
        aud = compute_aud_feature(params, data["auds"],
                                  data["aud_ids"].long(), i, cfg, False)
        return aud, data["exprs"][i]

    def calls(name):
        params, latents, torso = pairs[name]
        aud, expr = cond(params, 1)
        head = ((params, pose, bc), dict(aud=aud, expr=expr,
                                         latent=latents[0]))
        comp = ((params, torso, pose, pose0, bc), dict(
            aud=aud, signal=torso_signal(aud, pose, cfg.dim_aud_body),
            expr=expr, latent=latents[0]))
        return head, comp

    res = {"head": {}, "composite": {}}
    torch.set_grad_enabled(False)
    try:
        # 14c: the probes, the caches, the occupancy cut, ragged rays
        params, latents, torso = pairs["checkpoint"]
        print(f"phase 14c depth-band probes of the checkpoint pair at "
              f"{hw}x{hw} (the plain frame, f32, 64+128, {sds.size} frames)")
        t0 = time.perf_counter()
        band_h = er.subject_depth_range(cfg, params, latents, sds)
        head_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        band_t = er.torso_depth_range(cfg, torso, params, sds)
        torso_s = time.perf_counter() - t0
        print(f"  subject_depth_range {band_h[0]:.4f}-{band_h[1]:.4f} in "
              f"{head_s:.2f} s; torso_depth_range {band_t[0]:.4f}-"
              f"{band_t[1]:.4f} in {torso_s:.2f} s (config {near}-{far}; "
              "the config's own when no ray holds foreground)")
        for lo, hi in (band_h, band_t):
            if not near <= lo < hi <= far:
                raise AssertionError(f"band {lo}-{hi} outside [{near}, {far}]")
        cache = "output/chip_smoke_fast"
        shutil.rmtree(cache, ignore_errors=True)
        os.makedirs(cache)
        er.cached_depth_band(cache, "head", state.step, lambda: band_h)
        er.cached_depth_band(cache, "torso", state.step, lambda: band_t)
        back = (er.cached_depth_band(cache, "head", state.step, _no_probe),
                er.cached_depth_band(cache, "torso", state.step, _no_probe))
        if back != (band_h, band_t):
            raise AssertionError(f"depth_bands.json read back {back}")
        mask, kc = er.foreground_prior(sds)
        probes = [0, sds.size - 1]
        poses = [sds.poses[i] for i in probes]
        conds = [cond(params, i) for i in probes]
        key = dict(base_mask=mask, poses=poses, conds=conds, near=near,
                   far=far, latent=latents[0])
        t0 = time.perf_counter()
        occ, k_occ = er.cached_occupancy_prior(
            cache, state.step, lambda: er.field_occupancy_prior(
                ncfg, params, hw, hw, sds.focal, poses, conds, near, far,
                rcfg, mask, latent=latents[0], **where), **key)
        occ_s = time.perf_counter() - t0
        occ_back, k_back = er.cached_occupancy_prior(cache, state.step,
                                                     _no_probe, **key)
        if not (np.array_equal(occ_back, occ) and k_back == k_occ):
            raise AssertionError("the occupancy prior did not read back")
        print(f"  field_occupancy_prior over {len(probes)} probe frames in "
              f"{occ_s:.2f} s: prior {int(mask.sum())} px (k_coarse {kc}) "
              f"-> {int(occ.sum())} px (k_coarse {k_occ}); depth_bands.json "
              "and the occupancy prior read back without a probe")
        sp, sl, _ = pairs["seeded"]
        ragged = _phase_ragged(fr, sp, ncfg, (*cond(sp, 1), sl[0]), sds,
                               pose, mask, near, far, dev)
        res["probes"] = {"band_head": band_h, "band_torso": band_t,
                         "head_s": head_s, "torso_s": torso_s,
                         "occ_s": occ_s, "prior_px": int(mask.sum()),
                         "occ_px": int(occ.sum()), "ragged": ragged}

        # 14a: the head-only fast renderers
        one = {K2: 0, K1: 2}
        modes = {
            f"pruned keep {FAST_KEEP}": dict(keep_fraction=FAST_KEEP),
            "pruned keep 1.0": dict(keep_fraction=1.0),
            f"prior-masked keep {FAST_KEEP}": dict(
                keep_fraction=FAST_KEEP, prior_mask=mask, k_coarse=kc),
            f"prior-masked + occupancy cut keep {FAST_KEEP}": dict(
                keep_fraction=FAST_KEEP, prior_mask=occ, k_coarse=k_occ)}
        for name in pairs:
            head_call, _ = calls(name)
            full = er.make_frame_renderer(ncfg, *view, **where)
            want = full(*head_call[0], **head_call[1])
            fg = _foreground_share(er._render_field(
                head_call[0][0], ncfg, hw, hw, sds.focal, pose,
                bc.reshape(-1, 3), near, far, rcfg, sds.cx, sds.cy,
                **head_call[1]))
            full_ms = _time_ms(lambda: full(*head_call[0], **head_call[1]),
                               3)
            print(f"phase 14a head-only fast modes, {name} head, {hw}x{hw} "
                  f"D=8 W=256 64+128 (full-fidelity frame {full_ms:.2f} ms; "
                  f"rays with foreground mass > 0.5: {fg:.4f})")
            head = {"full_ms": full_ms, "foreground_share": fg}
            for tag, kw in modes.items():
                if name == "seeded" and "occupancy" in tag:
                    continue      # the cut is the checkpoint head's
                render = er.make_pruned_frame_renderer(ncfg, *view, **where,
                                                       **kw)
                if kw.get("k_coarse", 1) == 0:
                    got = render(*head_call[0], **head_call[1])
                    if not torch.equal(got.reshape(-1, 3), bc.reshape(-1, 3)):
                        raise AssertionError(f"{tag}: an empty cut must "
                                             "leave the plate")
                    print(f"  {tag}: the cut is empty (no ray holds "
                          "foreground mass): the plate, no launch")
                    head[tag] = {"launches": {K2: 0, K1: 0}, "empty": True}
                    continue
                head[tag] = _fast_frame(
                    fr, tag, render, head_call, one, want,
                    hw * hw % 256 if tag == "pruned keep 1.0" else None)
            res["head"][name] = head

        # 14b: the composite fast renderer
        mh, mt = er.foreground_prior_fields(sds)
        two = {K2: 2, K1: 2}
        for name in pairs:
            _, comp_call = calls(name)
            full = er.make_composite_frame_renderer(ncfg, tcfg, *view,
                                                    **where)
            want = full(*comp_call[0], **comp_call[1])
            full_ms = _time_ms(lambda: full(*comp_call[0], **comp_call[1]),
                               3)
            print(f"phase 14b composite fast renderer, {name} pair (full "
                  f"composite frame {full_ms:.2f} ms); per-field priors head "
                  f"{int(mh.sum())} px, torso {int(mt.sum())} px; bounds "
                  f"head {band_h[0]:.4f}-{band_h[1]:.4f}, torso "
                  f"{band_t[0]:.4f}-{band_t[1]:.4f}")
            comp = {"full_ms": full_ms}
            tag = f"composite keep {FAST_KEEP}, per-field priors + bounds"
            comp[tag] = _fast_frame(fr, tag, er.make_composite_fast_renderer(
                ncfg, tcfg, *view, **where, keep_head=FAST_KEEP,
                keep_torso=FAST_KEEP, prior_mask_head=mh,
                prior_mask_torso=mt, bounds_head=band_h,
                bounds_torso=band_t), comp_call, two, want, None)
            # each field leaves its budget's remainder coarse
            comp["composite keep 1.0"] = _fast_frame(
                fr, "composite keep 1.0", er.make_composite_fast_renderer(
                    ncfg, tcfg, *view, **where, keep_head=1.0,
                    keep_torso=1.0), comp_call, two, want,
                2 * (hw * hw % 256))
            res["composite"][name] = comp
    finally:
        torch.set_grad_enabled(True)

    # 14d: the CLIs on phase 13's subject directory
    res["clis"] = _phase_fast_clis(fr, subject, dev)
    launches = {K2: 0, K1: 0}
    for part in (*res["head"].values(), *res["composite"].values(),
                 res["clis"]):
        for r in part.values():
            if isinstance(r, dict) and "launches" in r:
                for k in launches:
                    launches[k] += r["launches"][k]
    res.update(launches=launches, errs=ragged["errs"],
               seconds=time.perf_counter() - t_phase)
    print(f"  phase 14 took {res['seconds']:.1f} s; launches {launches}")
    return res


def _occupancy_cached(ckpt_dir: str):
    """The occupancy prior render_val --occ_prior cached beside the
    checkpoint (the newest file)."""
    import glob

    import numpy as np

    paths = glob.glob(os.path.join(ckpt_dir, "occ_prior_*.npy"))
    return np.load(max(paths, key=os.path.getmtime))


def _phase_fast_clis(fr, subject: dict, dev: str) -> dict:
    """Phase 14d: the fast flags of render_val and eval_reenact on phase
    13's subject directory, each .avi held against the frames returned,
    with the launches per frame."""
    from idealnerf_tpu_torch.cli import eval_reenact, render_val

    head = subject["train_head"]["ckpt_dir"]
    torso = subject["train_torso"]["ckpt_dir"]
    root = "output/chip_smoke_fast/video"
    base = ["--config", subject["io"]["config"], *PAPER_FLAGS, "--device",
            dev, "--basedir", "output/chip_smoke_fast/logs", "--head_ckpt",
            head]
    runs = {
        "render_val --pruned 40 --prior_masked 1 --occ_prior 1 "
        "--tighten_bounds 1": (render_val.main, [
            "--pruned", "40", "--prior_masked", "1", "--occ_prior", "1",
            "--tighten_bounds", "1"], "subject_head_val.avi", {K2: 0, K1: 2}),
        "eval_reenact --fast 40 --prior 1": (eval_reenact.main, [
            "--fast", "40", "--prior", "1", "--max_frames", "3"],
            "subject_head.avi", {K2: 0, K1: 2}),
        "eval_reenact --fast 40 --prior 1 --torso_ckpt": (eval_reenact.main, [
            "--fast", "40", "--prior", "1", "--max_frames", "3",
            "--torso_ckpt", torso], "subject_head.avi", {K2: 2, K1: 2}),
        "eval_reenact --tighten_bounds 1": (eval_reenact.main, [
            "--tighten_bounds", "1", "--max_frames", "3"],
            "subject_head.avi", {K2: 1, K1: 1}),
    }
    print("phase 14d the fast CLIs on the subject directory")
    out = {}
    for n_run, (tag, (main_fn, flags, avi, per_frame)) in enumerate(
            runs.items()):
        save = os.path.join(root, str(n_run))
        banded = os.path.exists(os.path.join(head, "depth_bands.json"))
        fr.reset_launch_counts()
        r = main_fn([*base, *flags, "--save_path", save])
        video = r["frames"] if "video" not in r else r["video"]
        n = len(video)
        launches = _frame_launches(fr)
        if "--occ_prior" in flags and not _occupancy_cached(head).any():
            # a field with no foreground mass: every ray composites the
            # plate, and the renderer launches nothing
            per_frame = {K2: 0, K1: 0}
            print("  (the head's occupancy cut is empty: plate frames)")
        want = {k: v * n for k, v in per_frame.items()}
        print(f"  {tag}: {n} frames, {r['frame_ms']:.1f} ms/frame; launches "
              f"{launches} (want {want})"
              + (f"; band {r['tightened_bounds']}" if "tightened_bounds" in r
                 else "")
              + ("; band read from depth_bands.json" if "--tighten_bounds"
                 in flags and banded else ""))
        if launches != want:
            raise AssertionError(f"{tag}: launched {launches}, want {want}")
        out[tag] = {"frames": n, "frame_ms": r["frame_ms"],
                    "launches": launches,
                    "avi": _avi_check(os.path.join(save, avi), video, tag)}
    return out


K3 = "fused_render_delta"
# phase 15: a 450x450 subject of 24 train + 24 val frames, its head trained
# 63 epochs (1,512 steps at the rehearsal's N_rand 3072), its torso 500
# steps; the sweep's rungs and the harness's clip, refresh and s_delta
GATE_FRAMES = 48
GATE_EPOCHS = 63
GATE_TORSO_STEPS = 500
GATE_RUNGS = "64+128,32+64,16+32"
GATE_CLIP, GATE_REFRESH, GATE_S_DELTA = 20, 8, (32, 16)


def _temporal_launches(n: int, refresh: int, fields: int) -> dict:
    """K2/K1/K3 of one temporal clip of n frames: each field renders a
    keyframe every ``refresh`` frames (K2 + K1) and a delta frame (K3)
    otherwise."""
    kf = -(-n // refresh)
    return {K2: fields * kf, K1: fields * kf, K3: fields * (n - kf)}


def _add(total: dict, part: dict, times: int = 1) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + times * v
    return total


@contextlib.contextmanager
def _delta_spy():
    """Records (s_delta, rays) of every K3 call the temporal renderers make
    (they import the wrapper by name); the wrapper still counts."""
    from idealnerf_tpu_torch.eval import temporal

    real, calls = temporal.fused_render_delta, []

    def spy(*a, **kw):
        calls.append((a[11] + a[12] + 1, int(a[3].shape[0])))
        return real(*a, **kw)

    temporal.fused_render_delta = spy
    try:
        yield calls
    finally:
        temporal.fused_render_delta = real


def _refusal(main_fn, argv) -> str:
    """The CLI's refusal: parser.error's exit code 2 and its message."""
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            main_fn(argv)
        except SystemExit as e:
            if e.code != 2:
                raise AssertionError(f"exit code {e.code}, want 2") from e
            return err.getvalue().strip().splitlines()[-1]
    raise AssertionError(f"{argv}: no refusal")


def _gate_text(op: dict, td: dict, mode: str) -> str:
    """The picked point and its evidence row: agreement, dB against GT and
    the margin under the 0.05 dB gate."""
    from idealnerf_tpu_torch.eval.operating_points import GATE_DB, mode_key

    pt = dict(s=op["s_delta"], st=op["s_delta_torso"],
              keep=op["delta_keep"], keep_t=op["delta_keep_torso"],
              uni=op["uni_frac"], blend=op["kf_blend"],
              dil=op["dilate_every"], roll=op["roll_k"],
              rt=op["roll_k_torso"], fz=op["freeze_z_torso"],
              hp=op["head_parse"])
    key = mode_key(pt)
    if mode == "head":
        key = "head_only_" + key
    row = td["modes"][key]
    same = row.get("psnr_temporal_vs_full_same_bounds")
    return (f"{key} (refresh {op['refresh']}, rung {op['keyframe_rung']}): "
            f"{row['psnr_temporal_vs_full']:.3f} dB against the full "
            f"render" + (f" ({same:.3f} in the same bounds)"
                         if same is not None else "")
            + f", {row['delta_psnr_vs_gt']:+.3f} dB against GT, margin "
            f"{GATE_DB - row['delta_psnr_vs_gt']:.3f} dB under the gate")


def _phase_gates(fr, fm, fmg, dev: str = "cuda", hw: int = 450,
                 frames: int = GATE_FRAMES, epochs: int = GATE_EPOCHS,
                 torso_steps: int = GATE_TORSO_STEPS,
                 rungs: str = GATE_RUNGS, clip: int = GATE_CLIP,
                 refresh: int = GATE_REFRESH,
                 s_delta=GATE_S_DELTA) -> dict:
    """Phase 15: the quality-gate harness and the gated operating points.
    15a: scripts.rehearsal makes a with-torso subject of ``frames`` frames
    (half of them the val split) and trains its head for ``epochs`` epochs
    and its torso for ``torso_steps`` steps through the CLIs (K4 2 and K6
    2 a head step, K4 4 and K6 2 a torso step). 15b: scripts.sample_sweep
    over ``rungs`` (K2 and K1 once a val frame and rung). 15c:
    scripts.temporal_delta --refresh --frames --s_delta --tighten
    --auto_rung on the val split: the composite and head-only clips at
    full fidelity and in each temporal mode, launches as the code implies
    (``_temporal_launches``), every K3 call at a measured s_delta. 15d:
    gated_video_config for head and comp; where a gate opens, serve and
    eval_reenact --auto_temporal run at its point (the refresh through
    the keyframe count, the s_delta through every K3 call, the keep
    through its rays); where it is closed, the CLIs refuse; and serve
    --auto_temporal --roll_k 4, a cadence the harness did not measure, is
    refused in any case. At least one gate must open."""
    from idealnerf_tpu_torch.cli import eval_reenact, serve
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.eval.operating_points import gated_video_config
    from idealnerf_tpu_torch.eval.renderer import (
        foreground_prior, foreground_prior_fields,
    )
    from idealnerf_tpu_torch.eval.temporal import _prior_sel
    from idealnerf_tpu_torch.scripts import (
        rehearsal, sample_sweep, temporal_delta,
    )

    t_phase = time.perf_counter()
    root = "output/chip_smoke_gates"
    shutil.rmtree(root, ignore_errors=True)
    subject = os.path.join(root, "subject")
    res, launches = {}, {}

    # 15a: the subject and its training
    common = ["--out", subject, "--hw", str(hw), "--frames", str(frames),
              "--train_fraction", "0.5", "--with_torso", "--device", dev]
    rehearsal.main([*common, "--phase", "make"])
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    tr = rehearsal.main([*common, "--phase", "train", "--epochs",
                         str(epochs), "--torso_steps", str(torso_steps)])
    tr = tr["train"]
    hs, ts = tr["head"]["step"], tr["torso"]["step"]
    got = {"fused_point_mlp": fm.launch_counts["fused_point_mlp"],
           "fused_point_mlp_grad": fmg.launch_counts["fused_point_mlp_grad"]}
    want = {"fused_point_mlp": 2 * hs + 4 * ts,
            "fused_point_mlp_grad": 2 * hs + 2 * ts}
    print(f"phase 15a rehearsal make + train: {hw}x{hw}, {frames} frames "
          f"(val {frames - frames // 2}); head {hs} steps in "
          f"{tr['head']['wall_s']:.1f} s (loss "
          f"{tr['head']['last']['loss']:.5f}, PSNR "
          f"{tr['head']['last']['psnr']:.3f}), torso {ts} steps in "
          f"{tr['torso']['wall_s']:.1f} s (PSNR "
          f"{tr['torso']['last']['psnr']:.3f}); launches {got} (want "
          f"{want})")
    if dev == "cuda" and got != want:
        raise AssertionError(f"training launched {got}, want {want}")
    res["train"] = tr
    _add(launches, got)
    cfg = ExperimentConfig.from_file(os.path.join(subject,
                                                  "HeadNeRF_config.txt"))
    head_ckpt, torso_ckpt = tr["head"]["ckpt_dir"], tr["torso"]["ckpt_dir"]

    # 15b: the sample sweep
    n_val = frames - int(frames * 0.5)
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = sample_sweep.main(["--out", subject, "--rungs", rungs,
                               "--device", dev])
    got = {k: fr.launch_counts[k] for k in (K2, K1, K3)}
    n_rungs = len(rungs.split(","))
    want = {K2: n_rungs * n_val, K1: n_rungs * n_val, K3: 0}
    secs = time.perf_counter() - t0
    print(f"phase 15b sample_sweep over {rungs} ({secs:.1f} s): "
          + ", ".join(
              f"{k} {v['psnr']:.3f} dB ({v['frame_ms']:.1f} ms/frame, "
              f"{v[next(d for d in v if d.startswith('delta'))]:+.3f})"
              for k, v in sweep.items()) + f"; launches {got}")
    if got != want:
        raise AssertionError(f"sample_sweep launched {got}, want {want}")
    res["sweep"] = sweep
    _add(launches, got)

    # 15c: the harness
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    with _delta_spy() as calls:
        td = temporal_delta.main([
            "--subject_dir", subject, "--frames", str(clip), "--refresh",
            str(refresh), "--s_delta", *map(str, s_delta), "--tighten",
            "--auto_rung", "--device", dev])
    secs = time.perf_counter() - t0
    n = td["frames"]
    got = {k: fr.launch_counts[k] for k in (K2, K1, K3)}
    # the full clips, 2 + 1 fields, at the config's bounds and (--tighten)
    # within the tightened bands
    want = {K2: 6 * n, K1: 6 * n, K3: 0}
    for fields in (2, 1):
        _add(want, _temporal_launches(n, refresh, fields), len(s_delta))
    print(f"phase 15c temporal_delta ({secs:.1f} s): {n} frames, refresh "
          f"{refresh}, keyframe rung {td['keyframe_rung']}, bands "
          f"{td['tightened_bounds']}; full composite "
          f"{td['psnr_full_vs_gt']:.3f} dB, head "
          f"{td['psnr_head_full_vs_gt']:.3f} dB against GT; launches {got} "
          f"(want {want}); K3 s_delta {sorted({c[0] for c in calls})}")
    for k, v in td["modes"].items():
        print(f"  {k}: " + json.dumps(v))
    for kind, fit in td["delta_cost_fit"].items():
        print(f"  cost fit {kind}: " + (json.dumps(
            {k: v for k, v in fit.items() if k != "points"})
            if fit else "none (the times do not order the points)"))
    if got != want or {c[0] for c in calls} != set(s_delta):
        raise AssertionError(f"temporal_delta launched {got}, want {want}; "
                             f"K3 at s_delta {sorted({c[0] for c in calls})}")
    if not all(math.isfinite(v["psnr_temporal_vs_gt"])
               for v in td["modes"].values()):
        raise AssertionError("temporal_delta wrote a non-finite PSNR")
    res["temporal_delta"] = td
    _add(launches, got)

    # 15d: the gated operating points through the CLIs
    gates = {m: gated_video_config(subject, m) for m in ("head", "comp")}
    for m, op in gates.items():
        print(f"phase 15d {m} gate: " + (
            "open, " + _gate_text(op, td, m) if op else "closed"))
    if not any(gates.values()):
        raise AssertionError("no gate opened: train the phase-15 subject "
                             "longer")
    val = load_transforms_dataset(subject, "val", near=cfg.near,
                                  far=cfg.far)
    n_px = hw * hw
    prior_rays = {"head": (len(_prior_sel(foreground_prior(val)[0], n_px)),),
                  "comp": tuple(len(_prior_sel(m, n_px)) for m in
                                foreground_prior_fields(val))}
    base = ["--config", os.path.join(subject, "HeadNeRF_config.txt"),
            "--head_ckpt", head_ckpt, "--device", dev, "--auto_temporal",
            subject, "--max_frames", str(clip)]
    res["gates"] = {}
    for mode, op in gates.items():
        argv = base + (["--torso_ckpt", torso_ckpt] if mode == "comp"
                       else [])
        fields = 2 if mode == "comp" else 1
        if op is None:
            fr.reset_launch_counts()
            msg = {name: _refusal(main_fn, argv) for name, main_fn in
                   (("serve", serve.main),
                    ("eval_reenact", eval_reenact.main))}
            print(f"  {mode}: both CLIs refuse: {msg['serve']}")
            if any(fr.launch_counts.values()):
                raise AssertionError(f"a refused {mode} run launched")
            res["gates"][mode] = {"open": False, "refusal": msg}
            continue
        s_want = {op["s_delta"], op["s_delta_torso"] or op["s_delta"]}
        keep_all = (op["delta_keep"] >= 1.0 and (
            op["delta_keep_torso"] is None or op["delta_keep_torso"] >= 1.0))
        out = {"open": True, "point": op}
        for name, main_fn in (("serve", serve.main),
                              ("eval_reenact", eval_reenact.main)):
            fr.reset_launch_counts()
            with _delta_spy() as calls:
                r = main_fn(argv)
            got = {k: fr.launch_counts[k] for k in (K2, K1, K3)}
            if name == "serve":
                n_run, kf = r["frames"], r["keyframes"]
                live = {k: got[k] - fields * WARMUP[k] for k in got}
                ms = f"delta p50 {r['delta_p50_ms']:.2f} ms"
            else:
                n_run, kf = r["frames"], -(-r["frames"] // op["refresh"])
                live = got
                ms = f"{r['frame_ms']:.2f} ms/frame, PSNR {r['psnr']:.3f}"
            want = {K2: fields * kf, K1: fields * kf,
                    K3: fields * (n_run - kf)}
            rays = {c[1] for c in calls}
            rays_ok = (rays == set(prior_rays[mode]) if keep_all else
                       max(rays) < max(prior_rays[mode]))
            print(f"  {mode} {name} --auto_temporal: {n_run} frames, "
                  f"{kf} keyframes, {ms}; live launches {live} (want "
                  f"{want}); K3 s_delta {sorted({c[0] for c in calls})}, "
                  f"rays {sorted(rays)} (prior {prior_rays[mode]})")
            if (live != want or kf != -(-n_run // op["refresh"])
                    or {c[0] for c in calls} != s_want or not rays_ok):
                raise AssertionError(f"{mode} {name} --auto_temporal did "
                                     f"not run at {op}")
            out[name] = {"frames": n_run, "keyframes": kf,
                         "launches": got}
            _add(launches, got)
        res["gates"][mode] = out
    # a cadence without evidence of its own is refused, open gates or not
    fr.reset_launch_counts()
    msg = _refusal(serve.main, base + ["--roll_k", "4"])
    print(f"  serve --auto_temporal --roll_k 4 refused: {msg}")
    if any(fr.launch_counts.values()) or "roll_k=4" not in msg:
        raise AssertionError("serve --roll_k 4 was not refused as a closed "
                             "gate")
    res["roll_refusal"] = msg
    res.update(launches=launches, seconds=time.perf_counter() - t_phase,
               subject=subject)
    print(f"  phase 15 took {res['seconds']:.1f} s; launches {launches}")
    return res


def _grad_gap(got: dict, ref: dict):
    """(worst norm-relative error, its parameter), (lowest correlation,
    its parameter) of per-parameter gradients against ``ref``'s."""
    import torch

    worst, low = (0.0, ""), (1.0, "")
    for n, g in got.items():
        r = ref[n]
        worst = max(worst, (_norm_rel(g, r), n))
        if g.numel() > 1:  # a one-element bias has no correlation
            low = min(low, (float(torch.corrcoef(torch.stack(
                [g.reshape(-1).double(), r.reshape(-1).double()]))[0, 1]),
                n))
    return worst, low


@contextlib.contextmanager
def _swapped_backward(fmg):
    """Inside the block, the training autograd Function's backward runs
    f32 autograd of the plain MLP (_autograd_packed_grad) in place of the
    gradient kernels, on the same packed net, points and cotangent. Yields
    a one-element list that counts the replacement's calls."""
    kept, calls = fmg.point_mlp_grad, [0]

    def replacement(*a):
        calls[0] += 1
        return _autograd_packed_grad(*a)

    fmg.point_mlp_grad = replacement
    try:
        yield calls
    finally:
        fmg.point_mlp_grad = kept


def _phase_train_f32(args, fm, fmg, head_ckpt: str, rays: int = 2048,
                     dev: str = "cuda") -> dict:
    """Phase 16: the exact-f32 training path. cli.train_head.main
    --train_fused 1 (finite loss; K4, the backward and the f32 passes
    twice a step, the bf16 passes never); the ms per step and a profiled
    step's idle share at train_fused 1 and 2 (``_profile_train_step``);
    then one head step (on ``head_ckpt``) and one torso step at
    train_fused 1 on fixed coordinates, no draws: the same step with the
    backward swapped for f32 autograd of the plain MLP at the step's own
    cotangent (_swapped_backward) gives the same loss (1e-6 relative) and
    every parameter gradient within GRAD_TOL["f32"]["autograd"]; against
    train_fused 0, whose forward is f32 where K4's is bf16, the loss and
    gradients are held to phase 12b's bounds (GRAD_TOL["bf16"]), and the
    same gap at train_fused 2 is printed beside it."""
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import train_head
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.sampler import sample_ray_coords
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.head import make_frame_loss
    from idealnerf_tpu_torch.train.state import init_params
    from idealnerf_tpu_torch.train.torso import (
        make_torso_frame_loss, torso_ray_budget,
    )

    t_phase = time.perf_counter()
    H = W = args.train_hw
    shutil.rmtree("output/chip_smoke_train_f32", ignore_errors=True)
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_head.main([
        "--synthetic", str(args.train_frames), "--synthetic_hw", str(H),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--N_rand", str(rays), "--N_samples", "64", "--N_importance", "128",
        "--epochs", str(args.train_epochs), "--i_print", "5",
        "--i_weights", "10", "--device", dev, "--train_fused", "1",
        "--basedir", "output/chip_smoke_train_f32", "--expname", "head"])
    steps = res["step"]
    counts, want = _train_launches(fm, fmg, steps, 1)
    first, last = res["history"][0][1], res["history"][-1][1]
    print(f"phase 16 train_head --train_fused 1: {steps} steps on "
          f"{args.train_frames} frames of {H}x{W}, D=8 W=256 N_rand {rays} "
          f"64+128; loss {first['loss']:.5f} -> {last['loss']:.5f}, PSNR "
          f"{first['psnr']:.3f} -> {last['psnr']:.3f}; launches {counts}")
    vals = [first["loss"], last["loss"], first["psnr"], last["psnr"]]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("train_fused 1 produced a non-finite loss")
    if counts != want:
        raise AssertionError(f"train_fused 1 launched {counts}, want {want}")
    out = {"steps": steps, "first": first, "last": last, "launches": counts,
           "step": {tf: _profile_train_step(args, tf, "16") for tf in (1, 2)}}
    print("  train step: " + "; ".join(
        f"train_fused {tf} {r['step_ms']:.2f} ms/step, idle share "
        f"{_num(r['idle_share'], '.3f')}" for tf, r in out["step"].items()))

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           N_rand=rays)
    ds = make_synthetic_dataset(n_frames=args.train_frames, H=H, W=W,
                                dim_expr=76, with_torso=True)
    ck = CheckpointManager(head_ckpt).restore()
    head = init_params(cfg, ds.size).params
    head.load_state_dict(ck["params"])
    head, latent = head.to(dev), ck["latent_codes"].to(dev)
    data = ds.to_device(dev)
    torso, _ = _torso_setup(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    head_coords = torch.stack(
        [torch.randint(0, n, (rays,), generator=gen, device=dev)
         for n in (H, W)], 1)
    budget, rect, box = torso_ray_budget(cfg, H, W, dev)
    torso_coords = sample_ray_coords(
        torch.Generator(device=dev).manual_seed(1), H, W, rect, box,
        torch.zeros((H, W), dtype=torch.uint8, device=dev), budget)

    def head_step(c):
        head.zero_grad(set_to_none=True)
        loss, _ = make_frame_loss(c, ds, False, dev)(
            head, latent, data, 1, head_coords, None)
        loss.backward()
        return float(loss.detach()), {
            n: p.grad.detach().clone() for n, p in head.named_parameters()
            if p.grad is not None}

    def torso_step(c):
        torso.zero_grad(set_to_none=True)
        loss, _ = make_torso_frame_loss(c, ds, True, dev)(
            torso, head, latent, data, 1, torso_coords, None)
        loss.backward()
        return float(loss.detach()), {
            n: p.grad.detach().clone() for n, p in torso.named_parameters()}

    tol_f32 = GRAD_TOL["f32"]["autograd"]
    tol, ltol = GRAD_TOL["bf16"]["autograd"], GRAD_TOL["bf16"]["plain"]
    min_corr = 1.0 - tol ** 2 / 2
    def counted(step, tf):
        fmg.reset_launch_counts()
        return step(dataclasses.replace(cfg, train_fused=tf)), dict(
            fmg.launch_counts)

    for name, step in (("head", head_step), ("torso", torso_step)):
        runs, launches = {}, {}
        for tf in (1, 0, 2):
            runs[tf], launches[tf] = counted(step, tf)
        with _swapped_backward(fmg) as calls:
            runs["swap"], launches["swap"] = counted(step, 1)
        k1, ks = launches[1], launches["swap"]
        print(f"  {name} step launches at train_fused 1: {k1}; with the "
              f"backward swapped: {ks}, the replacement called {calls[0]} "
              "times")
        if not (k1["fused_point_mlp_grad"] > 0
                and k1["grad_pass_a_f32"] == k1["grad_pass_b_f32"]
                == k1["fused_point_mlp_grad"]
                and k1["grad_pass_a"] == k1["grad_pass_b"] == 0):
            raise AssertionError(f"the train_fused 1 {name} step did not run "
                                 f"the f32 passes: {k1}")
        if not (calls[0] == k1["fused_point_mlp_grad"]
                and not any(ks.values())):
            raise AssertionError(f"the swapped {name} step did not run the "
                                 f"replacement alone: {ks}, {calls[0]} calls")
        (l1, g1), (l0, g0) = runs[1], runs[0]
        swap_l = abs(l1 - runs["swap"][0]) / abs(l1)
        swap, _ = _grad_gap(g1, runs["swap"][1])
        gap1, low1 = _grad_gap(g1, g0)
        gap2, low2 = _grad_gap(runs[2][1], g0)
        lerr = abs(l1 - l0) / abs(l0)
        print(f"  {name} step at train_fused 1 ({len(g1)} parameters): with "
              f"the backward swapped for f32 autograd of the plain MLP at "
              f"its cotangent, loss {l1:.6f} vs {runs['swap'][0]:.6f} "
              f"(relative {swap_l:.2e}, tol 1e-6; bitwise "
              f"{l1 == runs['swap'][0]}), worst gradient norm-relative "
              f"{swap[0]:.3e} ({swap[1]}; tol {tol_f32:g}); against "
              f"train_fused 0: loss {l0:.6f} (relative {lerr:.2e}, tol "
              f"{ltol:g}), worst gradient {gap1[0]:.3e} ({gap1[1]}; tol "
              f"{tol:g}), lowest correlation {low1[0]:.6f} (> "
              f"{min_corr:.5f}); train_fused 2 against 0: worst "
              f"{gap2[0]:.3e} ({gap2[1]}), lowest correlation "
              f"{low2[0]:.6f}")
        if not (swap_l <= 1e-6 and swap[0] <= tol_f32):
            raise AssertionError(f"the f32 backward of a {name} step "
                                 "disagrees with f32 autograd")
        if not (lerr <= ltol and gap1[0] <= tol and low1[0] > min_corr):
            raise AssertionError(f"the train_fused 1 {name} step disagrees "
                                 "with train_fused 0")
        out[name] = {"vs_autograd_backward": {"loss_rel": swap_l,
                                              "worst": swap},
                     "vs_train_fused_0": {"loss_rel": lerr, "worst": gap1,
                                          "lowest_corr": low1},
                     "train_fused_2_vs_0": {"worst": gap2,
                                            "lowest_corr": low2}}
        del runs
    del head, torso, data
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16 took {out['seconds']:.1f} s")
    return out


def _finite_numbers(tree, where: str = "") -> None:
    """Raise on any non-finite number in a JSON-like tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_numbers(v, f"{where}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _finite_numbers(v, f"{where}/{i}")
    elif isinstance(tree, float) and not math.isfinite(tree):
        raise AssertionError(f"{where}: non-finite {tree}")


def _script_json(name: str, res: dict) -> None:
    """A script's JSON on a line of its own, its numbers held finite."""
    _finite_numbers(res, name)
    print(f"  {name} " + json.dumps(res))


K4, K6 = "fused_point_mlp", "fused_point_mlp_grad"
MEASURE_STEPS = 20       # train_profile's steps a variant
MEASURE_PUSHES = 240     # stream_latency's pushes a mode: p99 over 200+
MEASURE_REPS = 5         # the profiles' window
STAGE_ATOL = 1e-6        # a stage chain against its whole frame: the same
                         # kernels on the same inputs


def _phase_measure(head_ckpt: str, gates: dict, dev: str = "cuda",
                   hw: int = 450, clip: int = 3) -> dict:
    """Phase 17: the measurement scripts' ``main`` on the card, each JSON
    printed and its numbers finite. 17a train_profile (MEASURE_STEPS
    steps a variant at N_rand 3072, 64+128, train_fused 2: K4 and K6
    twice a step in every variant, all of which run the backward); 17b
    stream_latency over phase 15's subject, evidence and checkpoints,
    MEASURE_PUSHES pushes, comp and head: at an open gate K3 launches
    once per live field and delta frame of the timed stream, at a closed
    one it returns 1 and launches nothing; 17c temporal_profile and 17d
    comp_profile at ``hw``² (MEASURE_REPS reps): their stages run in order
    give the whole frame's image (within STAGE_ATOL); 17e composite_delta
    over ``clip`` frames of phase 15's val clip (fast 16+32, --tighten):
    its full clip equals, bitwise, ``make_composite_frame_renderer``
    called frame by frame as phase 12 calls it, on the same inputs; 17f
    audatt_peak on phase 8's checkpoint over the subject's audio track
    (the model's config from the ``args.txt`` train_head wrote beside
    it). Returns the launches of all of it."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli.common import load_head, load_torso
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.eval.operating_points import gated_video_config
    from idealnerf_tpu_torch.eval.renderer import (
        make_composite_frame_renderer,
    )
    from idealnerf_tpu_torch.scripts import (
        audatt_peak, comp_profile, composite_delta, stream_latency,
        temporal_profile, timing, train_profile,
    )
    from idealnerf_tpu_torch.train.torso import torso_nerf_config, torso_signal

    t_phase = time.perf_counter()
    out_dir = "chiprun_out/measure"
    os.makedirs(out_dir, exist_ok=True)
    subject = gates["subject"]
    ckpts = ["--head_ckpt", gates["train"]["head"]["ckpt_dir"],
             "--torso_ckpt", gates["train"]["torso"]["ckpt_dir"]]
    res, before = {}, timing.launch_snapshot()

    # 17a: the step bisection
    t0 = time.perf_counter()
    tp = train_profile.main(["--steps", str(MEASURE_STEPS), "--hw", str(hw),
                             "--device", dev, "--out",
                             f"{out_dir}/train_profile.json"])
    print(f"phase 17a train_profile ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} {tp[k]['ms_per_step']:.2f} ms"
                      for k in train_profile.VARIANTS)
          + f"; sampler {tp['sampler_ms']:.2f}, Adam vs SGD "
          f"{tp['adam_vs_sgd_ms']:.2f}, optimizer {tp['optimizer_ms']:.2f}")
    _script_json("train_profile", tp)
    for k in train_profile.VARIANTS:
        steps = tp[k]["steps"]
        got = {n: tp[k]["launches"].get(n, 0) for n in (K4, K6)}
        if dev == "cuda" and got != {K4: 2 * steps, K6: 2 * steps}:
            raise AssertionError(f"train_profile {k}: {steps} steps "
                                 f"launched {got}")
    res["train_profile"] = tp

    # 17b: serving at the gated points
    res["stream_latency"] = {}
    for mode in ("comp", "head"):
        t0 = time.perf_counter()
        op = gated_video_config(subject, mode)
        snap = timing.launch_snapshot()
        r = stream_latency.main([
            "--evidence_dir", subject, "--mode", mode, "--frames",
            str(MEASURE_PUSHES), "--device", dev, *ckpts, "--out",
            f"{out_dir}/stream_latency_{mode}.json"])
        if op is None:
            print(f"phase 17b stream_latency --mode {mode}: no open gate, "
                  f"returned {r}")
            if r != 1 or timing.launches_since(snap):
                raise AssertionError(f"stream_latency {mode} without a gate "
                                     f"returned {r} or launched")
            res["stream_latency"][mode] = {"open": False}
            continue
        live = 1 + int(mode == "comp" and not op["freeze_z_torso"]
                       and not op["roll_k_torso"])
        k3 = r["launches"]["stream"].get(K3, 0)
        print(f"phase 17b stream_latency --mode {mode} "
              f"({time.perf_counter() - t0:.1f} s): refresh "
              f"{op['refresh']}, s_delta {op['s_delta']}, rung "
              f"{op['keyframe_rung']}: p50 {r['p50_ms']:.2f} p95 "
              f"{r['p95_ms']:.2f} p99 {r['p99_ms']:.2f} ms, keyframe p50 "
              f"{r['keyframe_p50_ms']}, delta p50 {r['delta_p50_ms']:.2f}, "
              f"40 ms hit rate {r['deadline_40ms_hit_rate']:.3f}, launch "
              f"floor {r['local_launch_floor_ms']:.3f} ms, compute slope "
              f"{r['compute_isolation']['compute_ms_per_frame']:.2f} ms; "
              f"K3 {k3} for {r['delta_frames']} delta frames x {live}")
        _script_json(f"stream_latency_{mode}", r)
        if r["emitted"] != MEASURE_PUSHES or (
                dev == "cuda" and k3 != live * r["delta_frames"]):
            raise AssertionError(f"stream_latency {mode}: emitted "
                                 f"{r['emitted']}, K3 {k3}")
        res["stream_latency"][mode] = r

    # 17c, 17d: the stage splits, each chain against its whole frame
    for tag, mod in (("17c", temporal_profile), ("17d", comp_profile)):
        t0 = time.perf_counter()
        name = mod.__name__.rsplit(".", 1)[-1]
        r = mod.main(["--reps", str(MEASURE_REPS), "--hw", str(hw),
                      "--device", dev, "--out", f"{out_dir}/{name}.json"])
        print(f"phase {tag} {name} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["stages_ms"].items())
              + f" ms; whole {r['end_to_end_ms']:.2f}, glue "
              f"{r['glue_ms']:.2f}; stage chain vs whole frame max abs "
              f"{r['stage_chain_max_abs_err']:.3g} (tol {STAGE_ATOL:g})")
        _script_json(name, r)
        if not r["stage_chain_max_abs_err"] <= STAGE_ATOL:
            raise AssertionError(f"{name}: the stages do not give the frame")
        res[name] = r

    # 17e: the composite fast mode's quality on phase 15's pair
    t0 = time.perf_counter()
    r = composite_delta.main([
        "--subject_dir", subject, "--frames", str(clip), "--samples", "16",
        "--importance", "32", "--tighten", "--device", dev, *ckpts, "--out",
        f"{out_dir}/composite_delta.json"])
    full = r.pop("frames_rendered")["full"]
    cfg = ExperimentConfig.from_file(os.path.join(subject,
                                                  "HeadNeRF_config.txt"))
    ds = load_transforms_dataset(cfg.datadir, "val", near=cfg.near,
                                 far=cfg.far, gt_dirs="com_imgs")
    st = load_head(argparse.Namespace(seed=0, head_ckpt=ckpts[1]), cfg,
                   ds.size)
    head, torso = st.params.to(dev), load_torso(ckpts[3], cfg, dev)
    comp = make_composite_frame_renderer(
        cfg.face_nerf_config(), torso_nerf_config(cfg), *ds.hw, ds.focal,
        ds.near, ds.far, cfg.render_config(), cx=ds.cx, cy=ds.cy)
    poses = torch.from_numpy(ds.poses).to(dev)
    bc = torch.from_numpy(ds.bc_img).to(dev).float() / 255
    with torch.no_grad():
        auds = head["aud_net"](torch.from_numpy(
            ds.auds[ds.aud_ids[:clip]].astype(np.float32)).to(dev))
    want = np.stack([comp(
        head, torso, poses[i], poses[0], bc, aud=auds[i],
        signal=torso_signal(auds[i], poses[i], cfg.dim_aud_body),
        expr=(torch.from_numpy(ds.exprs[i].astype(np.float32)).to(dev)
              if cfg.dim_expr else None),
        latent=st.latent_codes[0].to(dev)).clamp(0.0, 1.0).cpu().numpy()
        for i in range(clip)])
    same = bool(np.array_equal(full, want))
    print(f"phase 17e composite_delta ({time.perf_counter() - t0:.1f} s): "
          f"{r['frames']} frames, fast {r['fast_schedule']} keep "
          f"{r['keep']}: {r['psnr_fast_vs_full']:.3f} dB against the full "
          f"render, full {r['psnr_full_vs_gt']:.3f} / fast "
          f"{r['psnr_fast_vs_gt']:.3f} dB against GT, "
          f"{r['ms_per_frame_full_warm']:.1f} / "
          f"{r['ms_per_frame_fast_warm']:.1f} ms a frame; full clip "
          f"bitwise make_composite_frame_renderer's: {same}")
    _script_json("composite_delta", r)
    if not same:
        raise AssertionError("composite_delta's full clip is not the "
                             "composite renderer's")
    res["composite_delta"] = r

    # 17f: the trained AudioAttNet's attention
    r = audatt_peak.main(["--ckpt", head_ckpt, "--subject", subject,
                          "--config", os.path.join(os.path.dirname(head_ckpt),
                                                   "args.txt"),
                          "--device", dev, "--out",
                          f"{out_dir}/audatt_peak.json"])
    print(f"phase 17f audatt_peak (step {r['step']}, {r['frames']} "
          f"windows): centre share {r['argmax_at_center_fraction']:.3f}, "
          f"centre weight {r['mean_center_weight']:.4f} (uniform "
          f"{r['uniform_weight']:.4f})")
    _script_json("audatt_peak", r)
    res["audatt_peak"] = r
    res.update(launches=timing.launches_since(before),
               seconds=time.perf_counter() - t_phase)
    print(f"  phase 17 took {res['seconds']:.1f} s; launches "
          f"{res['launches']}")
    return res


VARIANT_EXTRAS = {"face_nerf_agg": "agg", "attention_nerf": "self_att"}
VARIANT_HW, VARIANT_RAYS, UNET_RAYS = 450, 2048, 1024
HELD_SEED = 11           # the seeded weights phase 18's held steps run on
FG_LEVEL, MIN_FG = 2 / 255, 0.01  # a held frame: 1 % of pixels off the plate
# attention_nerf's self-attention runs over one row: its softmax is 1, so
# the query and key layers get no gradient on any path
STRUCTURAL_ZERO = {"attention_nerf": tuple(
    f"self_att.{m}.{p}" for m in "qk" for p in ("weight", "bias"))}
SECOND_CROP = 256        # the paper's crop: 8 tiles of 8,192 rays
SECOND_HOLD_CROP = 96    # 9,216 rays: two tiles, the second padded
UNET_FEATURE_TOL = 1e-4  # the card's f32 convs against the host's, of max


def _cfg_of(flags, **kw):
    """The ExperimentConfig the port's CLIs resolve from ``flags``."""
    from idealnerf_tpu_torch.cli.common import build_parser, resolve_config

    cfg = resolve_config(build_parser("").parse_known_args(flags)[0])
    return dataclasses.replace(cfg, **kw)


def _fused_vs_plain(tag: str, step, cfg, fused: int = 2,
                    structural=()) -> dict:
    """``step(cfg) -> (loss, {name: grad})`` at train_fused ``fused`` (2 or
    1: K4's forward is bf16 in both) against 0, held to phase 12b's
    bounds on every gradient. The gradients named in ``structural`` are
    zero by construction and must be zero on both paths; any other zero
    gradient on the plain path fails (a dead net would hold nothing)."""
    tol, ltol = GRAD_TOL["bf16"]["autograd"], GRAD_TOL["bf16"]["plain"]
    min_corr = 1.0 - tol ** 2 / 2
    (l2, g2), (l0, g0) = (step(dataclasses.replace(cfg, train_fused=tf))
                          for tf in (fused, 0))
    zero = sorted(n for n, g in g0.items() if float(g.abs().max()) == 0.0)
    zero_on_card = sorted(n for n in structural
                          if float(g2[n].abs().max()) == 0.0)
    worst, low = _grad_gap({n: g for n, g in g2.items()
                            if n not in structural}, g0)
    lerr = abs(l2 - l0) / abs(l0)
    print(f"  {tag}, train_fused {fused} vs 0 ({len(g2)} parameters, "
          f"zero gradients {zero}, by construction {sorted(structural)}): "
          f"loss {l2:.6f} vs {l0:.6f} (relative {lerr:.2e}, tol {ltol:g}); "
          f"worst gradient norm-relative {worst[0]:.3e} ({worst[1]}; tol "
          f"{tol:g}), lowest correlation {low[0]:.6f} ({low[1]}; > "
          f"{min_corr:.5f})")
    if not (lerr <= ltol and worst[0] <= tol and low[0] > min_corr
            and zero == zero_on_card == sorted(structural)
            and g2.keys() == g0.keys()):
        raise AssertionError(f"{tag}: the fused step disagrees with the "
                             f"plain, or zero gradients {zero} (on the "
                             f"card {zero_on_card}) are not "
                             f"{sorted(structural)}")
    return {"loss_rel": lerr, "worst": worst, "lowest_corr": low}


def _grad_dict(module) -> dict:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _variant_head(args, fm, fmg, fr, variant: str, dev: str, hw: int,
                  rays: int) -> dict:
    """18a for one variant: train, one step held, a frame held, serve."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli import render_val, serve, train_head
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.head import HeadTrainer, make_frame_loss
    from idealnerf_tpu_torch.train.state import init_params

    # softplus density: a 20-step relu run on this subject can empty a net
    # (the agg head's fine net rendered the plate), which holds nothing
    dims = [*PAPER_FLAGS, "--model_variant", variant, "--density_activation",
            "softplus", "--device", dev]
    data = ["--synthetic", str(args.train_frames), "--synthetic_hw",
            str(args.train_hw)]
    base = f"output/chip_smoke_{variant}"
    shutil.rmtree(base, ignore_errors=True)
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_head.main([*data, *dims, "--N_rand", str(rays),
                           "--epochs", str(args.train_epochs),
                           "--i_print", "5", "--basedir", base,
                           "--expname", "head"])
    steps = res["step"]
    counts, want = _train_launches(fm, fmg, steps)
    first, last = res["history"][0][1], res["history"][-1][1]
    print(f"phase 18a {variant} train_head: {steps} steps, loss "
          f"{first['loss']:.5f} -> {last['loss']:.5f}, PSNR "
          f"{first['psnr']:.3f} -> {last['psnr']:.3f}; launches {counts}")
    if not all(math.isfinite(m[k]) for _, m in res["history"]
               for k in ("loss", "psnr")):
        raise AssertionError(f"{variant}: non-finite loss or PSNR")
    if counts != want:
        raise AssertionError(f"{variant} train_head launched {counts}, "
                             f"want {want}")
    launches = {K4: counts[K4], K6: counts[K6]}

    cfg = _cfg_of(dims)
    H = W = args.train_hw
    ds = make_synthetic_dataset(n_frames=args.train_frames, H=H, W=W,
                                dim_expr=76)
    # the step is held on seeded weights, at every gradient
    params = init_params(cfg, ds.size, torch.Generator().manual_seed(
        HELD_SEED)).params.to(dev)
    latent = torch.ones(ds.size, 32, device=dev)
    d = ds.to_device(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    coords = torch.stack([torch.randint(0, n, (rays,), generator=gen,
                                        device=dev) for n in (H, W)], 1)

    def step(c):
        params.zero_grad(set_to_none=True)
        loss, _ = make_frame_loss(c, ds, False, dev)(params, latent, d, 1,
                                                     coords, None)
        loss.backward()
        return float(loss.detach()), _grad_dict(params)

    held = _fused_vs_plain(f"18a {variant} step", step, cfg,
                           structural=STRUCTURAL_ZERO.get(variant, ()))
    if not any(n.startswith(VARIANT_EXTRAS[variant] + ".")
               for n in _grad_dict(params)):
        raise AssertionError(f"{variant}: the extras got no gradient")
    del params, d
    tr = HeadTrainer(dataclasses.replace(cfg, N_rand=rays), ds, seed=0,
                     device=dev)
    fn = tr._step_fn(smooth=False)
    ms = _step_ms(lambda i: fn(tr.state, tr.data, i % ds.size,
                               tr.generator), 18)
    print(f"  {variant} step: {sorted(ms)[1]:.2f} ms, the median of 3 "
          f"windows of 18 steps (each {', '.join(f'{m:.2f}' for m in ms)})")
    del tr, fn
    torch.cuda.empty_cache()

    rv_args = [*data, *dims, "--head_ckpt", res["ckpt_dir"], "--max_frames",
               "1", "--save_path", base]
    fr.reset_launch_counts()
    rv = render_val.main(rv_args)
    rv_launches = _frame_launches(fr)
    with _plain_kernels():
        plain = render_val.main(rv_args)
    err = _agree(f"18a {variant} render_val frame vs the plain versions",
                 torch.from_numpy(rv["frames"][0]),
                 torch.from_numpy(plain["frames"][0]), corr=True)
    fg = float((np.abs(rv["frames"][0] - ds.bc_img / 255.0).max(-1)
                > FG_LEVEL).mean())
    print(f"  {variant} render_val: {rv['frame_ms']:.1f} ms, PSNR "
          f"{rv['psnr']:.3f}; launches {rv_launches}; {fg:.3f} of the "
          f"pixels off the plate by more than {FG_LEVEL:.4f}")
    if rv_launches != {K2: 1, K1: 1}:
        raise AssertionError(f"{variant} render_val launched {rv_launches}")
    if not fg >= MIN_FG:
        raise AssertionError(f"{variant}: the frame is the plate (an empty "
                             "field holds nothing)")
    for k, n in rv_launches.items():
        launches[k] = n

    fr.reset_launch_counts()
    stats = serve.main(["--synthetic", "10", "--synthetic_hw", str(hw),
                        *dims, "--head_ckpt", res["ckpt_dir"]])
    got = {k: fr.launch_counts[k] - WARMUP[k] for k in WARMUP}
    want = {K2: stats["keyframes"], K1: stats["keyframes"],
            K3: stats["delta_frames"]}
    print(f"  {variant} serve: {stats['frames']} frames of {hw}x{hw}, "
          f"keyframe {stats['keyframe_ms']} ms, delta p50 "
          f"{stats['delta_p50_ms']} ms; live launches {got} (want {want})")
    if not stats["finite"] or got != want:
        raise AssertionError(f"{variant} serve: launches {got}, want "
                             f"{want}, finite {stats['finite']}")
    for k, n in fr.launch_counts.items():
        if k in (K1, K2, K3):
            launches[k] = launches.get(k, 0) + n
    return {"steps": steps, "first": first, "last": last,
            "step_ms": sorted(ms)[1], "step_ms_windows": ms,
            "fused_vs_plain": held, "frame_err": err,
            "frame_ms": rv["frame_ms"], "serve": stats,
            "launches": launches}


def _second_stage_run(args, fm, fmg, head_ckpt: str, aud_path: str,
                      base: str, dev: str, tf: int, steps: int, what: str,
                      extra=()) -> dict:
    """cli.train_second_stage at crop SECOND_CROP from ``head_ckpt`` on the
    audio at ``aud_path`` for ``steps`` steps at train_fused ``tf`` with
    the flags ``extra``: finite losses, a checkpoint at the last step, K4
    four times a tile and K6 twice (the f32 or the bf16 passes), each
    step's ms and the run's peak memory."""
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import train_second_stage
    from idealnerf_tpu_torch.train.second_stage import TILE

    crop = SECOND_CROP
    tiles = -(-crop * crop // TILE)
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = train_second_stage.main([
        "--synthetic", str(args.train_frames), "--synthetic_hw",
        str(args.train_hw), *PAPER_FLAGS, "--device", dev, "--train_fused",
        str(tf), "--head_ckpt", head_ckpt, "--driving_aud", aud_path,
        "--crop", str(crop), "--steps", str(steps), "--i_print", "1",
        "--basedir", base, "--expname", f"fused{tf}", *extra])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {"fused_point_mlp": fm.launch_counts[K4], **fmg.launch_counts}
    f32 = tf == 1
    want = {K4: 4 * tiles * steps, K6: 2 * tiles * steps,
            "grad_pass_a": 0 if f32 else 2 * tiles * steps,
            "grad_pass_b": 0 if f32 else 2 * tiles * steps,
            "grad_pass_a_f32": 2 * tiles * steps if f32 else 0,
            "grad_pass_b_f32": 2 * tiles * steps if f32 else 0}
    ms = [1e3 / m["steps_per_sec_rolling"] for _, m in res["history"]]
    hist = [m for _, m in res["history"]]
    losses = ", ".join(f"{m['loss']:.5f}" for m in hist)
    print(f"phase {what}, crop {res['crop']} ({tiles} tiles), train_fused "
          f"{tf}: {steps} steps, losses {losses}; ms per step "
          f"{', '.join(f'{x:.1f}' for x in ms)} (the first with its "
          f"warm-up); peak memory {peak:.3f} GiB; launches {counts}")
    if not all(math.isfinite(m["loss"]) for m in hist):
        raise AssertionError(f"second stage train_fused {tf}: non-finite")
    if counts != want:
        raise AssertionError(f"second stage train_fused {tf} launched "
                             f"{counts}, want {want}")
    if CheckpointManager(res["ckpt_dir"]).latest_step() != steps:
        raise AssertionError(f"no second-stage checkpoint at {steps}")
    return {"steps": steps, "step_ms": ms, "peak_gib": peak,
            "first": hist[0], "last": hist[-1], "history": hist,
            "launches": counts}


def _second_stage(args, fm, fmg, head_ckpt: str, dev: str) -> dict:
    """18c: the crop step held, the CLI at train_fused 2 and 1, the
    profiled step, and ``--aux_landmark 1`` training in a process of its
    own."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.second_stage import (
        TILE, SecondStageTrainer, make_cross_identity_dataset,
        make_second_stage_loss,
    )
    from idealnerf_tpu_torch.train.state import init_params

    hold, crop = SECOND_HOLD_CROP, SECOND_CROP
    H = W = args.train_hw
    base = "output/chip_smoke_second"
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    drive = make_synthetic_dataset(n_frames=args.train_frames, H=H, W=W,
                                   dim_expr=76, seed=7)
    aud_path = os.path.join(base, "drive_aud.npy")
    np.save(aud_path, drive.auds)
    cfg = _cfg_of(PAPER_FLAGS)
    ident = make_synthetic_dataset(n_frames=args.train_frames, H=H, W=W,
                                   dim_expr=76)
    ds = make_cross_identity_dataset(ident, drive.auds)
    # held on seeded weights with softplus density, as 18a: every net live
    held_cfg = dataclasses.replace(cfg, density_activation="softplus")
    params = init_params(held_cfg, ds.size, torch.Generator().manual_seed(
        HELD_SEED)).params.to(dev)
    latent = torch.nn.Parameter(torch.ones(ds.size, 32, device=dev))
    d = ds.to_device(dev)
    n_tiles = -(-hold * hold // TILE)
    calls = {}

    def step(c):
        params.zero_grad(set_to_none=True)
        latent.grad = None
        fm.reset_launch_counts()
        fmg.reset_launch_counts()
        loss, _ = make_second_stage_loss(c, ds, hold, device=dev)(
            params, latent, d, 1, None)
        loss.backward()
        calls[c.train_fused] = {K4: fm.launch_counts[K4],
                                **fmg.launch_counts}
        return float(loss.detach()), {**_grad_dict(params),
                                      "latent_codes": latent.grad.clone()}

    what = (f"18c second stage, crop {hold} ({n_tiles} tiles of {TILE}, the "
            "last padded)")
    held = _fused_vs_plain(what, step, held_cfg)
    want = {K4: 4 * n_tiles, K6: 2 * n_tiles}
    if ({k: calls[2][k] for k in want} != want or calls[0][K4]
            or calls[0][K6]):
        raise AssertionError(f"the crop-{hold} step launched {calls}, want "
                             f"{want} at train_fused 2 and none at 0")
    # the f32 backward at the fine tile's 1,572,864 points: against
    # train_fused 0 as the bf16 one, and against the same step with f32
    # autograd of the plain MLP as its backward (phase 16's bound)
    held_f32 = _fused_vs_plain(what, step, held_cfg, fused=1)
    l1, g1 = step(dataclasses.replace(held_cfg, train_fused=1))
    with _swapped_backward(fmg):
        ls, gs = step(dataclasses.replace(held_cfg, train_fused=1))
    swap, _ = _grad_gap(g1, gs)
    tol = GRAD_TOL["f32"]["autograd"]
    print(f"  train_fused 1 with its backward swapped for f32 autograd of "
          f"the plain MLP: loss {l1:.6f} vs {ls:.6f}, worst gradient "
          f"norm-relative {swap[0]:.3e} ({swap[1]}; tol {tol:g})")
    if not (abs(l1 - ls) <= 1e-6 * abs(l1) and swap[0] <= tol):
        raise AssertionError("the f32 backward of a crop step disagrees "
                             "with f32 autograd")
    held_f32["vs_autograd_backward"] = swap
    del params, d, latent
    torch.cuda.empty_cache()

    launches = {K4: 0, K6: 0, "grad_pass_a_f32": 0, "grad_pass_b_f32": 0}
    runs = {}
    for tf, steps in ((2, 5), (1, 2)):
        runs[tf] = _second_stage_run(
            args, fm, fmg, head_ckpt, aud_path, base, dev, tf, steps,
            "18c train_second_stage")
        for k in launches:
            launches[k] += runs[tf]["launches"][k]

    tr = SecondStageTrainer(dataclasses.replace(cfg, train_fused=2), ident,
                            drive.auds, crop=crop, device=dev)
    prof = _profile(lambda: tr._step(tr.state, tr.data, 0, tr.generator),
                    f"second-stage step (crop {crop}, train_fused 2)",
                    "profile_second_stage_step.txt")
    del tr
    torch.cuda.empty_cache()

    # the command that refused naming A11 before the aux losses were
    # ported now trains (two steps, its checkpoint under base)
    proc = subprocess.run(
        [sys.executable, "-m", "idealnerf_tpu_torch.cli.train_second_stage",
         "--synthetic", "1", "--device", dev, "--aux_landmark", "1",
         "--steps", "2", "--i_print", "1", "--basedir", base, "--expname",
         "aux_cli"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    logged = [ln for ln in proc.stderr.splitlines() if "[2ND] step" in ln]
    aux = [float(ln.rsplit("aux ", 1)[1]) for ln in logged]
    print(f"  --aux_landmark 1 --steps 2: exit code {proc.returncode}; "
          f"{' | '.join(ln.split('[2ND] ')[1] for ln in logged)}")
    if not (proc.returncode == 0 and len(aux) == 2
            and all(math.isfinite(a) and a > 0 for a in aux)
            and CheckpointManager(os.path.join(
                base, "aux_cli_second", "ckpt")).latest_step() == 2):
        raise AssertionError("train_second_stage --aux_landmark 1 did not "
                             "train: " + proc.stderr[-2000:])
    return {"hold": held, "hold_f32": held_f32, "hold_launches": calls[2],
            "runs": runs, "profile": prof, "aux_cli": aux,
            "launches": launches, "drive_aud": aud_path}


def _unet(dev: str, hw: int, rays: int, steps: int = 5) -> dict:
    """18d: UNetTrainer at hw², its features against the host's."""
    import torch

    from idealnerf_tpu_torch.core.embedding import positional_encoding
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.unet import EMBED_IMG_MULTIRES, UNetTrainer

    cfg = _cfg_of(PAPER_FLAGS, N_rand=rays)
    ds = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=76)
    tr = UNetTrainer(cfg, ds, seed=0, device=dev)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(steps, log_every=1, on_metrics=lambda s, m: hist.append(m))
    wall = 1e3 * (time.perf_counter() - t0) / steps
    img = torch.from_numpy(ds.images[0]).float() / 255.0
    emb = positional_encoding(img, EMBED_IMG_MULTIRES)[None]
    unet = tr.params["unet"]
    with torch.no_grad():
        card = unet(emb.to(dev), embed_ln=emb.shape[-1]).cpu()
        host = unet.cpu()(emb, embed_ln=emb.shape[-1])
    err = float((card - host).abs().max() / host.abs().max())
    print(f"phase 18d UNetTrainer: {steps} steps at {hw}x{hw} (N_rand "
          f"{cfg.N_rand}, {cfg.N_samples}+{cfg.N_importance}), loss "
          f"{hist[0]['loss']:.5f} -> "
          f"{hist[-1]['loss']:.5f}, {wall:.1f} ms/step with the first; "
          f"features {tuple(card.shape)} card vs host: max error "
          f"{err:.2e} of their max (tol {UNET_FEATURE_TOL:g})")
    if not all(math.isfinite(m["loss"]) for m in hist):
        raise AssertionError("UNetTrainer produced a non-finite loss")
    if not err <= UNET_FEATURE_TOL:
        raise AssertionError("the card's UNet features disagree with the "
                             "host's")
    return {"losses": [m["loss"] for m in hist], "ms_per_step": wall,
            "feature_err": err}


def _phase_variants(args, fm, fmg, fr, head_ckpt: str) -> dict:
    """Phase 18: the model variants (18a), the baseline (18b), the second
    stage (18c) and the UNet trainer (18d) at 450²; their launches of
    K1-K4, K6 and the f32 passes."""
    import torch

    from idealnerf_tpu_torch.cli import train_baseline

    dev, hw, rays = "cuda", VARIANT_HW, VARIANT_RAYS
    t_phase = time.perf_counter()
    out, launches = {}, {}
    for variant in VARIANT_EXTRAS:
        out[variant] = _variant_head(args, fm, fmg, fr, variant, dev, hw,
                                     rays)
        launches = _add(launches, out[variant]["launches"])
    shutil.rmtree("output/chip_smoke_baseline", ignore_errors=True)
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_baseline.main([
        "--synthetic", str(args.train_frames), "--synthetic_hw",
        str(args.train_hw), *PAPER_FLAGS, "--device", dev, "--N_rand",
        str(rays), "--epochs", str(args.train_epochs), "--i_print", "5",
        "--basedir", "output/chip_smoke_baseline", "--expname", "base"])
    counts, want = _train_launches(fm, fmg, res["step"])
    last = res["history"][-1][1]
    print(f"phase 18b train_baseline: {res['step']} steps, loss "
          f"{res['history'][0][1]['loss']:.5f} -> {last['loss']:.5f}; "
          f"launches {counts}")
    if counts != want or not math.isfinite(last["loss"]):
        raise AssertionError(f"train_baseline launched {counts}, want {want}")
    out["baseline"] = {"steps": res["step"], "last": last,
                       "launches": counts}
    launches = _add(launches, {K4: counts[K4], K6: counts[K6]})
    out["second_stage"] = _second_stage(args, fm, fmg, head_ckpt, dev)
    launches = _add(launches, out["second_stage"]["launches"])
    out["unet"] = _unet(dev, hw, UNET_RAYS)
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 18 took {out['seconds']:.1f} s; launches {launches}")
    return out


# 19b's weights: a random 2DFAN-4's heatmap L1 is ~1e14 at its 256² crop
AUX_WEIGHTS = {"aux_landmark": 1e-15, "aux_vgg": 0.1, "aux_vggface": 0.1}
AUX_FLAGS = [a for k, w in AUX_WEIGHTS.items() for a in (f"--{k}", str(w))]
AUX_STEPS = 3            # 19b's steps at train_fused 2 (1 at train_fused 1)
PROXY_STEPS = 60         # 19c's FAN proxy steps at crop 256, batch 2
REHEARSAL_STEPS = 3      # 19c's rehearsal_2nd steps with the proxy
FAN_TOL = {"atol": 2e-3, "rtol": 1e-3}    # tests/test_fan.py:170
TAP_TOL = {"atol": 2e-5, "rtol": 2e-4}    # tests/test_vgg.py:62-63
AUX_GRAD_TOL = 1e-4      # the crop gradient against f64, norm-relative


def _close(tag: str, got, want, atol: float, rtol: float) -> float:
    """|got - want| <= atol + rtol |want| everywhere (numpy's allclose),
    printed with the max abs error; -> that error."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max())
    print(f"  {tag} {tuple(got.shape)}: max abs error {err:.3e} (max "
          f"{float(want.abs().max()):.3e}; atol {atol:g}, rtol {rtol:g})")
    if not (got.shape == want.shape
            and torch.allclose(got, want, rtol=rtol, atol=atol)):
        raise AssertionError(f"{tag}: the card disagrees with the host")
    return err


def _conv_macs(net, fn) -> int:
    """Multiply-adds of ``net``'s Conv2d layers in one call of ``fn``
    (forward hooks: output elements x cin x k x k)."""
    import torch

    total = [0]

    def hook(m, inp, out):
        total[0] += (out.numel() * m.in_channels * m.kernel_size[0]
                     * m.kernel_size[1] // m.groups)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        fn()
    for h in hooks:
        h.remove()
    return total[0]


def _aux_nets_vs_host(smi: str) -> dict:
    """19a: FAN at the paper's size (4 stacks, a 256² crop, 64² heatmaps;
    seeded as tests/test_fan.py seeds its torch net), VGG16 through
    relu5_3 and VGGFace on seeded weights at 256², each the same module on
    the card (cuDNN, f32 without TF32) and on the host, and the landmark
    loss's gradient with respect to the crop."""
    import copy

    import torch

    from idealnerf_tpu_torch.losses.landmark import make_fan_landmark_loss
    from idealnerf_tpu_torch.losses.vgg import (
        LPIPS_TAPS, init_vgg16, init_vggface,
    )
    from idealnerf_tpu_torch.pipeline.fan import (
        CROP_SIZE, FAN, NUM_MODULES, make_heatmap_detector,
    )

    dev = "cuda"
    print(f"phase 19a the aux nets, card vs host [{smi}]")
    torch.manual_seed(0)
    fan = FAN(NUM_MODULES)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in fan.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    fan.requires_grad_(False)
    nets = {"fan": fan, "vgg16": init_vgg16(2), "vggface": init_vggface(3)}
    card = {k: copy.deepcopy(n).to(dev) for k, n in nets.items()}
    x = torch.rand(1, 3, CROP_SIZE, CROP_SIZE, generator=g)
    errs = {}
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(card["fan"](x.to(dev)), fan(x),
                                       strict=True)):
            errs[f"fan_stack{i}"] = _close(f"FAN stack {i} heatmaps", a, b,
                                           **FAN_TOL)
        xv = 2.0 * x - 1.0
        for i, (a, b) in enumerate(zip(
                card["vgg16"].taps(xv.to(dev), LPIPS_TAPS),
                nets["vgg16"].taps(xv, LPIPS_TAPS), strict=True)):
            errs[f"vgg16_{LPIPS_TAPS[i]}"] = _close(
                f"VGG16 layer {LPIPS_TAPS[i]}", a, b, **TAP_TOL)
        for i, (a, b) in enumerate(zip(card["vggface"](x.to(dev)),
                                       nets["vggface"](x), strict=True)):
            errs[f"vggface_{i}"] = _close(f"VGGFace relu{i + 1}_1", a, b,
                                          **TAP_TOL)
    # the aux term's convolutions a step: the prediction's forward and
    # input gradient (the nets are frozen) and the target's forward
    macs = {"fan": _conv_macs(card["fan"], lambda: card["fan"](x.to(dev))),
            "vgg16": _conv_macs(card["vgg16"],
                                lambda: card["vgg16"].taps(xv.to(dev))),
            "vggface": _conv_macs(card["vggface"],
                                  lambda: card["vggface"](x.to(dev)))}
    bound = _bound(2 * 3 * sum(macs.values()), 0.0, "f32")
    print(f"  conv GMAC a forward at {CROP_SIZE}²: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in macs.items())
          + f"; a step's aux term (3 forwards' worth) at the f32 rate: "
          f"{bound['bound_ms']:.2f} ms")
    # the landmark loss and its gradient with respect to the crop, each
    # side's and the host's in float64 (the same FAN in double). The L1's
    # subgradient takes the sign of each heatmap difference: the gradient
    # is taken at the host's signs on every side (the flipped ones are
    # counted), so the gaps are the arithmetic's
    pred = torch.rand(CROP_SIZE, CROP_SIZE, 3, generator=g)
    target = torch.rand(CROP_SIZE, CROP_SIZE, 3, generator=g)
    sides = {"card": (card["fan"], dev, torch.float32),
             "host": (fan, "cpu", torch.float32),
             "f64": (copy.deepcopy(fan).double(), "cpu", torch.float64)}
    det = {w: make_heatmap_detector(n) for w, (n, _, _) in sides.items()}
    with torch.no_grad():
        diff = {w: det[w](pred.to(d, t)) - det[w](target.to(d, t))
                for w, (_, d, t) in sides.items() if w != "f64"}
    signs = torch.sign(diff["host"]) / diff["host"].numel()
    flips = int((torch.sign(diff["card"].cpu()) != torch.sign(
        diff["host"])).sum())
    losses, grads = {}, {}
    for w, (net, d, t) in sides.items():
        with torch.no_grad():
            losses[w] = float(make_fan_landmark_loss(net)(pred.to(d, t),
                                                          target.to(d, t)))
        p = pred.to(d, t).requires_grad_(True)
        (grads[w],) = torch.autograd.grad(
            (det[w](p) * signs.to(d, t)).sum(), p)
        grads[w] = grads[w].cpu().double()

    def gap(a, b):
        return float((grads[a] - grads[b]).norm() / grads[b].norm())

    card_f64, host_f64, rel = gap("card", "f64"), gap("host", "f64"), gap(
        "card", "host")
    lerr = abs(losses["card"] - losses["host"]) / abs(losses["host"])
    print(f"  landmark loss {losses['card']:.6e} vs {losses['host']:.6e} "
          f"(relative {lerr:.2e}; f64 {losses['f64']:.6e}); its gradient "
          f"with respect to the crop at the host's signs ({flips} of "
          f"{diff['host'].numel()} flipped on the card), norm-relative: "
          f"card vs host {rel:.3e}, card vs f64 {card_f64:.3e}, host vs f64 "
          f"{host_f64:.3e} (card vs f64 within {AUX_GRAD_TOL:g} or twice "
          f"the host's)")
    if not (lerr <= 1e-5
            and card_f64 <= max(AUX_GRAD_TOL, 2.0 * host_f64)):
        raise AssertionError("the landmark loss's gradient on the card "
                             "disagrees with the host's")
    errs.update(landmark_loss=lerr, landmark_grad=rel,
                landmark_grad_card_f64=card_f64,
                landmark_grad_host_f64=host_f64, landmark_sign_flips=flips)
    return {"errs": errs, "gmac": {k: v / 1e9 for k, v in macs.items()},
            "aux_bound_ms": bound["bound_ms"]}


def _phase_aux(args, fm, fmg, fr, head_ckpt: str, second: dict,
               gates: dict, smi: str) -> dict:
    """Phase 19: the second stage's aux losses (ROADMAP A11) on the card.
    19a ``_aux_nets_vs_host``. 19b: cli.train_second_stage at crop 256
    from phase 8's head on 18c's driving audio with --aux_landmark,
    --aux_vgg and --aux_vggface all on, AUX_STEPS steps at train_fused 2
    and one at 1: finite losses, an aux loss above zero, K4 four and K6
    two launches a tile and no other kernel launch, the checkpoint; ms
    per step and peak memory beside 18c's runs without aux, and a profiled
    step's busy time split into the convolutions (the aux nets) and the
    port's kernels beside 18c's. 19c: scripts.train_fan_proxy on phase
    15's subject at crop 256 for PROXY_STEPS steps, the landmark error
    before and after (it must fall), then scripts.rehearsal_2nd for REHEARSAL_STEPS steps
    with that proxy as --fan_npz."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli.train_second_stage import build_aux_loss
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.scripts import rehearsal_2nd, train_fan_proxy
    from idealnerf_tpu_torch.train.second_stage import TILE, SecondStageTrainer

    dev = "cuda"
    t_phase = time.perf_counter()
    out = {"nets": _aux_nets_vs_host(smi)}
    torch.cuda.empty_cache()

    # 19b: the CLI with the three aux terms
    base = "output/chip_smoke_aux"
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    tiles = -(-SECOND_CROP * SECOND_CROP // TILE)
    launches = {K4: 0, K6: 0, "grad_pass_a_f32": 0, "grad_pass_b_f32": 0}
    runs = {}
    for tf, steps in ((2, AUX_STEPS), (1, 1)):
        fr.reset_launch_counts()
        runs[tf] = _second_stage_run(
            args, fm, fmg, head_ckpt, second["drive_aud"], base, dev, tf,
            steps, f"19b train_second_stage {' '.join(AUX_FLAGS)}",
            AUX_FLAGS)
        aux = [m["aux_loss"] for m in runs[tf]["history"]]
        others = {k: n for k, n in fr.launch_counts.items() if n}
        no_aux = second["runs"][tf]
        print(f"  aux losses {', '.join(f'{a:.5f}' for a in aux)}; ms per "
              f"step {', '.join(f'{x:.1f}' for x in runs[tf]['step_ms'])} "
              f"and peak {runs[tf]['peak_gib']:.3f} GiB beside 18c without "
              f"aux {', '.join(f'{x:.1f}' for x in no_aux['step_ms'])} and "
              f"{no_aux['peak_gib']:.3f} GiB [{smi}]")
        if not all(math.isfinite(a) and a > 0 for a in aux) or others:
            raise AssertionError(f"train_fused {tf} with aux: aux losses "
                                 f"{aux}, other kernels launched {others}")
        for k in launches:
            launches[k] += runs[tf]["launches"][k]
    cfg = _cfg_of(PAPER_FLAGS, train_fused=2)
    ident = make_synthetic_dataset(n_frames=args.train_frames,
                                   H=args.train_hw, W=args.train_hw,
                                   dim_expr=76)
    aux_loss = build_aux_loss(argparse.Namespace(fan_npz=None,
                                                 **AUX_WEIGHTS), dev)
    tr = SecondStageTrainer(cfg, ident, np.load(second["drive_aud"]),
                            crop=SECOND_CROP, aux_loss=aux_loss, device=dev)
    prof = _profile(lambda: tr._step(tr.state, tr.data, 0, tr.generator),
                    f"second-stage step with aux (crop {SECOND_CROP}, "
                    "train_fused 2)", "profile_second_stage_aux_step.txt")
    del tr, aux_loss
    torch.cuda.empty_cache()

    def split(pr):
        return (f"device busy {_num(pr['device_busy_ms'], '.1f', ' ms')} "
                f"(convolutions {_num(pr['conv_ms'], '.1f', ' ms')}, K4 + "
                f"K6 {_num(pr['kernels_ms'], '.1f', ' ms')}), idle share "
                f"{_num(pr['idle_share'], '.3f')}")

    print(f"  the step with aux: {split(prof)}; 18c without aux: "
          f"{split(second['profile'])} [{smi}]")

    # 19c: the FAN proxy on phase 15's subject, then the rehearsal with it
    subject = gates["subject"]
    proxy = train_fan_proxy.main(["--out", subject, "--steps",
                                  str(PROXY_STEPS), "--device", dev])
    print(f"phase 19c train_fan_proxy: {proxy['train_crops']} crops of "
          f"{proxy['crop_size']}², {PROXY_STEPS} steps in "
          f"{proxy['wall_s']:.2f} s; landmark error "
          f"{proxy['landmark_err_hm_px_random_init']:.3f} -> "
          f"{proxy['landmark_err_hm_px_trained']:.3f} heatmap px [{smi}]")
    err0, err1 = (proxy["landmark_err_hm_px_random_init"],
                  proxy["landmark_err_hm_px_trained"])
    if not (math.isfinite(err0) and math.isfinite(err1) and err1 < err0):
        raise AssertionError(f"train_fan_proxy: the landmark error went "
                             f"from {err0} to {err1}, not down")
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    reh = rehearsal_2nd.main(["--out", subject, "--steps",
                              str(REHEARSAL_STEPS), "--device", dev])
    got = {K4: fm.launch_counts[K4], K6: fmg.launch_counts[K6]}
    want = {K4: 4 * tiles * REHEARSAL_STEPS, K6: 2 * tiles * REHEARSAL_STEPS}
    traj = reh["trajectory"]
    losses = ", ".join(f"{t['loss']:.5f} (aux {t['aux_loss']:.6f})"
                       for t in traj)
    ms = ", ".join(f"{x:.1f}" for x in reh["step_ms_rolling"])
    print(f"phase 19c rehearsal_2nd: {reh['steps']} steps at crop "
          f"{reh['crop']} with the {reh['fan']} FAN (probe "
          f"{reh['aux_probe_raw']:.4e}, weight {reh['aux_weight_used']:.4e})"
          f"; losses {losses}; ms per step {ms}; launches {got} [{smi}]")
    if not (reh["fan"] == "proxy" and got == want and len(traj)
            == REHEARSAL_STEPS and all(
                math.isfinite(t["loss"]) and math.isfinite(t["aux_loss"])
                and t["aux_loss"] > 0 for t in traj)):
        raise AssertionError(f"rehearsal_2nd with the proxy: launches {got} "
                             f"(want {want}), trajectory {traj}")
    _add(launches, got)
    out.update(runs=runs, profile=prof, proxy=proxy, rehearsal=reh,
               launches=launches, seconds=time.perf_counter() - t_phase)
    print(f"  phase 19 took {out['seconds']:.1f} s; launches {launches}")
    return out


PIPE_FRAMES = 32         # 20a's subject: frames of 450²
PIPE_AUDIO_S = 3.0       # and seconds of its aud.wav
PIPE_TRAIN_EPOCHS = 1    # train_head on its train split (29 frames)
# the tracking model of 20a and 20c: the reference-scale synthetic BFM
# stand-in (34,500 vertices, 68,242 triangles, id 100, exp 79)
PIPE_BFM = dict(n_id=100, n_exp=79, n_lat=150, n_lon=230, shell=True,
                with_contours=True, seed=5)
DS_TOL = {"atol": 2e-5, "rtol": 2e-4}     # tests/test_deepspeech.py:69
BISENET_TOL = {"atol": 2e-3, "rtol": 1e-3}  # tests/test_parsing_net.py:68
# 20b's rasterizer at 96², card against host and card against the host's
# float64 run, each bound absolute: near an edge the steep sigmoid and the
# edge distance's cancellation make f32 itself ill-conditioned (ROADMAP.md
# C7): the host's own f32 image lies 2.73e-3 from float64 in colour (0-255
# scale) and 2.5e-6 in alpha, its vertex gradient 9.5e-5 norm-relative;
# the card's gradient has read 1.25e-4 from float64 (PERF.md)
RASTER_TOL = {"rgb": 5e-3, "alpha": 1e-5, "grad": 3e-4}
# 20b's landmark stages: a fifth of the default 9 x 100 + 600 + 200 steps
# (20a's process_data runs them all on the card), host and card each; at
# these steps the final losses have read equal to 6 decimals, 4.86e-4
# relative at the default steps (PERF.md)
PIPE_FIT_STEPS = dict(steps_focal=20, steps_global=120, steps_refine=40)
TRACK_LOSS_TOL = 1e-4    # the landmark stages' final loss, relative
# 20b's initial photometric fit: 3 of 5 frames at 48², 52 steps, past the
# rates' decay (update 50) and the loss weights' switch (step > 50). Its
# Adam turns float noise into a share of a step (ROADMAP.md C9): on the
# host alone 1-3 threads lie up to 1.31e-4 (pose) and 5.05e-3 (texture
# and light) from its 8-thread run, two card runs (an atomic index-add in
# the backward) up to 1.34e-4 and 4.66e-3 (scripts/photo_spread.py,
# PERF.md), hence bounds of about three times that; its loss at steps 50
# and 51 from one point within 1e-5 relative
PHOTO_STEPS = 52
PHOTO_TOL = {"pose": 5e-4, "tex_light": 1.5e-2, "loss": 1e-5}


def _pipeline_subject(d: str, hw: int, n: int, seconds: float) -> None:
    """tests/test_pipeline.py:229-300's subject at ``hw``²: a bright
    face-like disk drifting over a dark background in ``n`` frames
    (``ori_imgs/*.jpg``), and ``seconds`` of a 330 Hz sine at 16 kHz
    (``aud.wav``)."""
    import wave

    import numpy as np

    from idealnerf_tpu_torch.cli.process_data import JPEG_QUALITY
    from idealnerf_tpu_torch.data.jpeg import write_jpeg

    os.makedirs(os.path.join(d, "ori_imgs"))
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:hw, 0:hw]
    s = hw / 64.0
    for i in range(n):
        cx, cy = (32 + i) * s, (28 + i % 2) * s
        disk = (xx - cx) ** 2 + (yy - cy) ** 2 < (14 * s) ** 2
        img = np.full((hw, hw, 3), 30, np.uint8)
        img[disk] = [200, 170, 150]
        img = np.clip(img.astype(int) + rng.randint(-8, 8, img.shape), 0,
                      255).astype(np.uint8)
        write_jpeg(os.path.join(d, "ori_imgs", f"{i}.jpg"), img,
                   JPEG_QUALITY)
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    samples = (np.sin(2 * np.pi * 330 * t) * 8000).astype("<i2")
    with wave.open(os.path.join(d, "aud.wav"), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(samples.tobytes())


def _pipeline_weights(root: str) -> dict:
    """Random full-width weights from the port's own init functions: FAN
    (4 stacks) as a torch .pth with a BatchNorm counter, BiSeNet (ResNet18
    widths) as an .npz, DeepSpeech at 2048 hidden units as a frozen graph,
    and the tracking model as a 3DMM_info.npy with its keys_info.npy."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.pipeline import deepspeech as pds
    from idealnerf_tpu_torch.pipeline.fan import init_fan
    from idealnerf_tpu_torch.pipeline.parsing_net import init_bisenet
    from idealnerf_tpu_torch.pipeline.tracking import Face3DMM

    paths = {k: os.path.join(root, f) for k, f in (
        ("fan", "fan.pth"), ("bisenet", "bisenet.npz"),
        ("deepspeech", "output_graph.pb"), ("bfm", "bfm/3DMM_info.npy"))}
    sd = {k: torch.from_numpy(v) for k, v in init_fan(1).items()}
    sd["bn1.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, paths["fan"])
    np.savez(paths["bisenet"], **init_bisenet(2))
    pds.save_frozen_graph(paths["deepspeech"], pds.consts_from_params(
        pds.random_params(torch.Generator().manual_seed(3), n_hidden=2048)))
    os.makedirs(os.path.dirname(paths["bfm"]))
    Face3DMM.synthetic(**PIPE_BFM).save(paths["bfm"])
    return paths


def _check_subject_dir(d: str, n: int, hw: int, n_exp: int) -> dict:
    """What process_data must have written for ``n`` frames of ``hw``²."""
    import numpy as np

    from idealnerf_tpu_torch.data.jpeg import jpeg_size
    from idealnerf_tpu_torch.eval.video import read_png

    aud = np.load(os.path.join(d, "aud.npy"))
    lms = [np.loadtxt(os.path.join(d, "ori_imgs", f"{i}.lms"))
           for i in range(n)]
    tp = np.load(os.path.join(d, "track_params.npz"))
    split = int(n * 10 / 11)
    docs = {}
    for name in ("train", "val"):
        with open(os.path.join(d, f"transforms_exp_{name}.json")) as fh:
            docs[name] = json.load(fh)
    sizes = {jpeg_size(os.path.join(d, sub, f"{i}.jpg"))
             for sub in ("com_imgs", "head_imgs") for i in range(n)}
    parse = read_png(os.path.join(d, "parsing", "0.png"))
    checks = {
        "aud.npy (N, 16, 29)": aud.shape == (n, 16, 29)
        and bool(np.isfinite(aud).all()),
        "ori_imgs/*.lms (68, 2)": all(x.shape == (68, 2)
                                      and np.isfinite(x).all() for x in lms),
        "parsing/*.png": parse.shape == (hw, hw, 3) and all(
            os.path.exists(os.path.join(d, "parsing", f"{i}.png"))
            for i in range(n)),
        "bc.jpg": jpeg_size(os.path.join(d, "bc.jpg")) == (hw, hw),
        "com_imgs/ head_imgs/": sizes == {(hw, hw)},
        "track_params.npz": tp["exp"].shape == (n, n_exp) and all(
            np.isfinite(tp[k]).all() for k in ("euler", "trans", "exp")),
        "transforms_exp_{train,val}.json": [
            len(docs[k]["frames"]) for k in ("train", "val")] == [
                split, n - split] and len(docs["train"]["frames"][0][
                    "exp"]) == n_exp,
        "HeadNeRF_config.txt": os.path.exists(os.path.join(
            d, "HeadNeRF_config.txt")),
    }
    print("  written: " + ", ".join(f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"process_data's directory is incomplete: "
                             f"{checks}")
    return {"parse_classes": {str(tuple(c)): int(m) for c, m in zip(
        *np.unique(parse.reshape(-1, 3), axis=0, return_counts=True))},
            "focal": float(tp["focal"]), "split": [split, n - split]}


def _pipeline_vs_host(d: str, weights: dict, smi: str) -> dict:
    """20b: the card's results against the port's own CPU path on the
    same inputs: BiSeNet's three heads on frame 0 at 512² (seeded as
    tests/test_parsing_net.py's activation test seeds its torch net);
    DeepSpeech's logits at 2048 hidden units on the subject's audio; one
    ``rasterize_soft`` image and its vertex gradient at 96² (the smoke
    model of track_bench); the landmark stages' final loss and focal of
    ``FaceTracker.fit`` (``PIPE_FIT_STEPS``) on the subject's landmarks.
    Each side's time."""
    import copy

    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli.process_data import _read_wav
    from idealnerf_tpu_torch.data.jpeg import read_jpeg
    from idealnerf_tpu_torch.pipeline import deepspeech as pds
    from idealnerf_tpu_torch.pipeline.audio import deepspeech_input_vector
    from idealnerf_tpu_torch.pipeline.parsing_net import (
        _MEAN, _STD, INFER_SIZE, BiSeNet,
    )
    from idealnerf_tpu_torch.pipeline.fan import resize_linear
    from idealnerf_tpu_torch.pipeline.tracking import (
        Face3DMM, FaceTracker, RasterConfig, rasterize_soft,
    )
    from idealnerf_tpu_torch.scripts import photo_spread

    print(f"phase 20b the pipeline's nets and tracker, card vs host [{smi}]")
    dev, n, out = "cuda", PIPE_FRAMES, {}

    def both(fn):
        """fn(device) on the host and the card -> (host, card, host s,
        card s)."""
        res, secs = {}, {}
        for side in ("cpu", dev):
            t0 = time.perf_counter()
            res[side] = fn(side)
            torch.cuda.synchronize()
            secs[side] = time.perf_counter() - t0
        return res["cpu"], res[dev], secs["cpu"], secs[dev]

    # BiSeNet
    torch.manual_seed(0)
    net = BiSeNet().eval().requires_grad_(False)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    img = torch.from_numpy(read_jpeg(os.path.join(d, "ori_imgs", "0.jpg"))
                           .astype(np.float32)) / 255.0
    x = (resize_linear(img, (INFER_SIZE, INFER_SIZE)) - torch.from_numpy(
        _MEAN)) / torch.from_numpy(_STD)
    x = x.permute(2, 0, 1)[None].contiguous()
    nets = {"cpu": net, dev: copy.deepcopy(net).to(dev)}
    with torch.no_grad():
        host, card, hs, cs = both(lambda side: nets[side](x.to(side)))
    errs = {}
    for i, (a, b) in enumerate(zip(card, host, strict=True)):
        errs[f"bisenet_head{i}"] = _close(
            f"BiSeNet head {i} logits at {INFER_SIZE}²", a, b, **BISENET_TOL)
    print(f"  BiSeNet forward at {INFER_SIZE}²: host {hs:.3f} s, card "
          f"{cs:.3f} s (first call)")
    out["bisenet_s"] = {"host": hs, "card": cs}
    with torch.no_grad():
        prof_bise = _profile(lambda: nets[dev](x.to(dev)),
                             f"BiSeNet forward at {INFER_SIZE}²",
                             "profile_bisenet.txt")
    del nets

    # DeepSpeech at 2048 hidden units on the subject's audio
    params = pds.load_params(weights["deepspeech"])
    audio, sr = _read_wav(os.path.join(d, "aud.wav"))
    vec = deepspeech_input_vector(audio, sr)
    ds = {side: pds.DeepSpeech.from_params(params, device=side)
          for side in ("cpu", dev)}
    host, card, hs, cs = both(lambda side: pds.deepspeech_logits(ds[side],
                                                                 vec))
    errs["deepspeech_logits"] = _close(
        f"DeepSpeech logits (T={vec.shape[0]}, 2048 hidden)", card, host,
        **DS_TOL)
    print(f"  DeepSpeech forward: host {hs:.3f} s, card {cs:.3f} s")
    out["deepspeech_s"] = {"host": hs, "card": cs}
    prof_ds = _profile(lambda: pds.deepspeech_logits(ds[dev], vec),
                       f"DeepSpeech logits of {vec.shape[0]} frames at "
                       "2048 hidden", "profile_deepspeech.txt")
    del ds

    # one rasterize_soft image and its vertex gradient at 96²
    model = Face3DMM.synthetic(with_contours=True, seed=5)
    rng = np.random.RandomState(0)
    n_id, n_exp = model.dims
    with torch.no_grad():
        geo = model.geometry(torch.from_numpy(rng.randn(1, n_id).astype(
            np.float32) * 0.3), torch.from_numpy(rng.randn(1, n_exp).astype(
                np.float32) * 0.3))[0] + torch.tensor([0.0, 0.0, -7.0])
        tex = model.texture(torch.from_numpy(rng.randn(1, model.n_tex).astype(
            np.float32) * 0.5))[0]
    focal, hw = 1200.0 * 96 / 450, 96
    vp = torch.stack([-focal * geo[:, 0] / geo[:, 2] + hw / 2,
                      focal * geo[:, 1] / geo[:, 2] + hw / 2, -geo[:, 2]], -1)
    cfg = RasterConfig(hw, hw)
    w = torch.randn(hw, hw, 4, generator=torch.Generator().manual_seed(4))

    def raster(side, dtype=torch.float32):
        v = vp.detach().to(side, dtype).requires_grad_(True)
        img, ov = rasterize_soft(v, model.tris, tex.to(side, dtype), cfg,
                                 return_overflow=True)
        (img * w.to(side, dtype)).sum().backward()
        return img.detach().cpu().double(), v.grad.cpu().double(), int(ov)

    host, card, hs, cs = both(raster)
    f64 = raster("cpu", torch.float64)
    # each pair within RASTER_TOL: card / host, card / f64, host / f64
    gaps = {}
    for pair, (a, b) in (("card-host", (card, host)),
                         ("card-f64", (card, f64)),
                         ("host-f64", (host, f64))):
        gaps[pair] = {"rgb": float((a[0][..., :3] - b[0][..., :3]).abs()
                                   .max()),
                      "alpha": float((a[0][..., 3] - b[0][..., 3]).abs()
                                     .max()),
                      "grad": _norm_rel(a[1], b[1])}
    print(f"  rasterize_soft {hw}² ({model.tris.shape[0]} triangles, "
          f"overflow {card[2]}/{host[2]}): "
          + "; ".join(f"{pair} colour {g['rgb']:.3e}, alpha "
                      f"{g['alpha']:.3e}, vertex gradient {g['grad']:.3e}"
                      for pair, g in gaps.items())
          + f" (tol colour {RASTER_TOL['rgb']:g} on the 0-255 scale, "
          f"alpha {RASTER_TOL['alpha']:g}, gradient {RASTER_TOL['grad']:g} "
          f"norm-relative); host {hs:.3f} s, card {cs:.3f} s")
    if not (all(g[k] <= RASTER_TOL[k] for g in gaps.values()
                for k in RASTER_TOL) and card[2] == host[2] == 0):
        raise AssertionError("rasterize_soft on the card disagrees with "
                             "the host or its float64 run")
    errs.update({f"raster_{k}_{pair.replace('-', '_')}": v
                 for pair, g in gaps.items() for k, v in g.items()})

    # the initial photometric fit, across the rates' decay and the loss
    # weights' switch, from one start: scripts.photo_spread's window case
    # (tests/test_torch_tracking.py's, its images without bin overflow)
    pcase = {side: photo_spread.window_case(side) for side in ("cpu", dev)}
    host, card, hs, cs = both(lambda side: pcase[side][
        "tracker"]._photometric_initial(
            pcase[side]["start"], pcase[side]["images"],
            pcase[side]["landmarks"], pcase[side]["focal"],
            batch=photo_spread.FIT_FRAMES, steps=PHOTO_STEPS))
    pgap = {"pose": max(float((card[0][k].cpu() - host[0][k]).abs().max())
                        for k in host[0]),
            "tex_light": max(float((card[i].cpu() - host[i]).abs().max())
                             for i in (1, 2))}
    print(f"  FaceTracker._photometric_initial (3 of 5 frames of 48², "
          f"{PHOTO_STEPS} steps): card vs host id / exp / euler / trans "
          f"max abs {pgap['pose']:.3e} (tol {PHOTO_TOL['pose']:g}), "
          f"texture and light {pgap['tex_light']:.3e} (tol "
          f"{PHOTO_TOL['tex_light']:g}); host {hs:.2f} s, card {cs:.2f} s")
    # the fit's loss on either side of its weight switch, from one point
    ploss = {}
    with torch.no_grad():
        for side, c in pcase.items():
            q0 = {k: v[:3] for k, v in c["start"].items() if k != "id"}
            q0.update(id=c["start"]["id"], tex=c["tex"] * 0.5,
                      light=c["light"][:3] + 0.05)
            tr = c["tracker"]
            ploss[side] = [float(tr._initial_loss(
                tr._make_renderer(c["focal"]), c["focal"], q0,
                torch.from_numpy(c["images"][:3]).to(side),
                torch.from_numpy(c["landmarks"][:3]).to(side), step))
                for step in (50, 51)]
    pgap["loss"] = max(abs(c - h) / abs(h) for c, h in zip(
        ploss[dev], ploss["cpu"]))
    print(f"  its loss at steps 50 / 51: card {ploss[dev][0]!r} / "
          f"{ploss[dev][1]!r}, host {ploss['cpu'][0]!r} / "
          f"{ploss['cpu'][1]!r} (relative {pgap['loss']:.3e}, tol "
          f"{PHOTO_TOL['loss']:g})")
    if not all(pgap[k] <= PHOTO_TOL[k] for k in PHOTO_TOL):
        raise AssertionError("the initial photometric fit on the card "
                             "disagrees with the host's")
    errs.update({f"photo_{k}": v for k, v in pgap.items()})
    out["photo_s"] = {"host": hs, "card": cs}
    del pcase

    # the landmark stages on the subject's landmarks, the BFM-scale model
    lms = np.stack([np.loadtxt(os.path.join(d, "ori_imgs", f"{i}.lms"))
                    for i in range(n)])
    bfm = {side: Face3DMM.load(weights["bfm"], device=side)
           for side in ("cpu", dev)}
    trackers = {side: FaceTracker(m, 450, 450) for side, m in bfm.items()}
    host, card, hs, cs = both(lambda side: trackers[side].fit(
        lms, **PIPE_FIT_STEPS))
    lerr = abs(card.loss - host.loss) / abs(host.loss)
    print(f"  FaceTracker.fit landmark stages ({n} frames, steps "
          f"{PIPE_FIT_STEPS}, "
          f"{bfm['cpu'].n_vertices} vertices): focal {card.focal:g} / "
          f"{host.focal:g}, final loss {card.loss!r} / {host.loss!r} "
          f"(relative {lerr:.3e}, tol {TRACK_LOSS_TOL:g}); host {hs:.2f} s, "
          f"card {cs:.2f} s")
    if not (card.focal == host.focal and lerr <= TRACK_LOSS_TOL):
        raise AssertionError("the tracker's landmark stages on the card "
                             "disagree with the host's")
    errs["track_loss"] = lerr
    out["track_s"] = {"host": hs, "card": cs}
    tr = trackers[dev]
    p0 = tr._init_params(n)
    gt = torch.from_numpy(lms.astype(np.float32)).to(dev)
    prof_fit = _profile(lambda: tr._fit_stage(p0, gt, card.focal, 50, 0.03,
                                              1e-3, 1e-2),
                        f"50 landmark-fit steps ({n} frames, contours)",
                        "profile_track_fit.txt")
    out.update(errs=errs, profile_bisenet=prof_bise,
               profile_deepspeech=prof_ds, profile_track_fit=prof_fit)
    return out


def _phase_pipeline(fm, fmg, fr, smi: str) -> dict:
    """Phase 20: the offline pipeline (ROADMAP A12) on the card. 20a: a
    synthetic 450² subject (``PIPE_FRAMES`` frames, ``PIPE_AUDIO_S`` s of
    audio) through ``python -m idealnerf_tpu_torch.cli.process_data`` in a
    process of its own, on its default device, every step with random
    full-width weights (``_pipeline_weights``); the directory it writes
    checked (``_check_subject_dir``), then train_head (K4, K6 twice a step)
    and render_val for one frame (K2, K1 once) from it. 20b
    ``_pipeline_vs_host``. 20c ``scripts.track_bench`` at 450² on the
    reference-scale model (zero overflow)."""
    import torch

    from idealnerf_tpu_torch.cli import render_val, train_head
    from idealnerf_tpu_torch.scripts import track_bench

    t_phase = time.perf_counter()
    hw, n = 450, PIPE_FRAMES
    root = "output/chip_smoke_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    d = os.path.join(root, "subject")
    t0 = time.perf_counter()
    _pipeline_subject(d, hw, n, PIPE_AUDIO_S)
    weights = _pipeline_weights(root)
    setup_s = time.perf_counter() - t0
    ffmpeg = shutil.which("ffmpeg")
    print(f"phase 20a process_data: {n} frames of {hw}² and "
          f"{PIPE_AUDIO_S:g} s of audio, weights written in {setup_s:.1f} s "
          f"({', '.join(f'{k} {os.path.getsize(p) / 2 ** 20:.0f} MiB' for k, p in weights.items())}); "
          f"ffmpeg on PATH: {ffmpeg or 'none'} [{smi}]")
    cmd = [sys.executable, "-m", "idealnerf_tpu_torch.cli.process_data",
           "--id_dir", d, "--fan_weights", weights["fan"],
           "--parse_weights", weights["bisenet"], "--deepspeech_pb",
           weights["deepspeech"], "--bfm", weights["bfm"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "process_data.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode:
        raise AssertionError(f"process_data exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    pd = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  process_data on {pd['device']}: {wall_s:.1f} s in its own "
          f"process; steps " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                         pd["steps"].items())
          + f"; peak {pd['peak_gib']:.3f} GiB [{smi}]")
    if not (pd["device"].startswith("cuda")
            and set(pd["steps"]) == {"audio", "landmarks", "parse", "bg",
                                     "decouple", "track", "transforms"}):
        raise AssertionError(f"process_data ran {pd}")
    n_exp = PIPE_BFM["n_exp"]
    written = _check_subject_dir(d, n, hw, n_exp)

    # the head from the directory it wrote
    flags = list(PAPER_FLAGS)
    flags[flags.index("--dim_expr") + 1] = str(n_exp)
    base = ["--config", os.path.join(d, "HeadNeRF_config.txt"), *flags,
            "--device", "cuda", "--basedir", os.path.join(root, "logs")]
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    t0 = time.perf_counter()
    th = train_head.main([*base, "--N_rand", "2048", "--epochs",
                          str(PIPE_TRAIN_EPOCHS), "--i_print", "1"])
    train_s = time.perf_counter() - t0
    steps = th["step"]
    counts, want = _train_launches(fm, fmg, steps)
    losses = [m["loss"] for _, m in th["history"]]
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    rv = render_val.main([*base, "--head_ckpt", th["ckpt_dir"],
                          "--max_frames", "1", "--save_path",
                          os.path.join(root, "video")])
    render_s = time.perf_counter() - t0
    rcounts = {k: fr.launch_counts[k] for k in (K2, K1)}
    print(f"  train_head on it: {steps} steps (D=8 W=256, dim_expr {n_exp}, "
          f"N_rand 2048) in {train_s:.1f} s, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {counts}; render_val 1 val frame in "
          f"{render_s:.1f} s, PSNR {rv['psnr']:.3f}, launches {rcounts}")
    if not (counts == want and steps > 0 and all(map(math.isfinite, losses))
            and rcounts == {K2: 1, K1: 1} and math.isfinite(rv["psnr"])):
        raise AssertionError(f"train_head/render_val on process_data's "
                             f"directory: launches {counts} (want {want}), "
                             f"{rcounts}; losses {losses}")
    launches = {K4: counts[K4], K6: counts[K6], K2: 1, K1: 1}
    torch.cuda.empty_cache()

    res_b = _pipeline_vs_host(d, weights, smi)
    torch.cuda.empty_cache()

    # 20c: track_bench at the reference scale
    tb = track_bench.main(["--out", os.path.join("chiprun_out",
                                                 "track_bench.json")])
    print(f"phase 20c track_bench: {tb['vertices']} vertices, {tb['tris']} "
          f"triangles at {tb['hw']}², overflow {tb['overflow']}, capacity "
          f"{tb['max_faces_per_tile']}: raster forward "
          f"{1e3 * tb['raster_forward_s']:.1f} ms ({tb['frames']} frames), "
          f"1-step window {tb['photometric_window_1step_s']:.3f} s, 40 "
          f"steps {tb['photometric_window_40step_s']:.2f} s "
          f"({1e3 * tb['s_per_photometric_step']:.1f} ms a step), peak "
          f"{tb['peak_gib']:.3f} GiB [{smi}]")
    if (tb["overflow"], tb["vertices"], tb["tris"], tb["hw"]) != (
            0, 34500, 68242, 450):
        raise AssertionError(f"track_bench: {tb}")
    out = {"process_data": pd, "process_data_wall_s": wall_s,
           "setup_s": setup_s, "written": written, "ffmpeg": ffmpeg,
           "train_head": {"steps": steps, "losses": losses,
                          "seconds": train_s},
           "render_val": {"psnr": rv["psnr"], "seconds": render_s},
           "vs_host": res_b, "track_bench": tb, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    print(f"  phase 20 took {out['seconds']:.1f} s; launches {launches}")
    return out


# phase 21: multi-device (ROADMAP A13) on the one card. The steps and the
# frames of a mesh are held against one device's on the same draws and
# weights: frames ray for ray (the kernels render whole rays per block),
# gradients within float reassociation (each rank's K6 sums half the
# rays, the all-reduce adds the halves), norm-relative per tensor
P21_FRAME_TOL = 1e-6
P21_GRAD_TOL = 1e-3
P21_STEPS = 3            # 21a's held steps, each side
P21_WINDOW = 6           # steps or frames a timing window (3 windows)
P21_KERNELS = ("fused_render_rays", "fused_render_coarse_hier", K4, K6)


def _p21_counts() -> dict:
    """This process's K1, K2, K4 and K6 launch counts."""
    from idealnerf_tpu_torch.kernels import fused_mlp, fused_mlp_grad
    from idealnerf_tpu_torch.kernels import fused_render

    c = {**fused_render.launch_counts, **fused_mlp.launch_counts,
         **fused_mlp_grad.launch_counts}
    return {k: c[k] for k in P21_KERNELS}


class _P21Launches:
    """Sums the launches of the code run inside ``with launches:`` blocks
    (the mesh's paths, not the one-device references beside them)."""

    def __init__(self):
        self.total = {k: 0 for k in P21_KERNELS}

    def __enter__(self):
        self._at = _p21_counts()

    def __exit__(self, *exc):
        now = _p21_counts()
        for k in P21_KERNELS:
            self.total[k] += now[k] - self._at[k]


def _p21_gap(got, want, names) -> tuple:
    """(the worst norm-relative gap of tensor lists, its tensor's name),
    each tensor against a floor of 1e-6 of the largest reference norm (a
    gradient the loss does not reach is zero on both sides)."""
    floor = 1e-6 * max(float(w.double().norm()) for w in want)
    return max((float((g.double() - w.double()).norm())
                / max(float(w.double().norm()), floor), n)
               for g, w, n in zip(got, want, names))


def _p21_names(params) -> list:
    """The names of ``TrainState.trainable()``'s tensors, in its order."""
    return [n for n, _ in params.named_parameters()] + ["latent_codes"]


def _p21_grads(tensors) -> list:
    import torch

    return [p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p) for p in tensors]


def _p21_zero(tensors) -> None:
    for p in tensors:
        p.grad = None


def _p21_busy_ms(run):
    """Device ms of one warm call of ``run`` in this process
    (torch.profiler), or None where the trace comes back empty. One call
    only, not PROFILE_TRIES: the ranks of a mesh must make the same calls,
    whatever each one's profiler sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return ms if ms > 0 else None


def _p21_sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _p21_timed(run, tag: str, out: dict, dev, window: int) -> None:
    """``out[tag]``: the ms per call of ``run(i)`` (the median of 3 wall
    windows of ``window`` calls after 2 of warm-up, each window closed by
    a device synchronize), the wall of one call and its device busy ms in
    this process. Every rank of a mesh calls it at once (the calls meet
    in collectives)."""
    for i in range(2):
        run(i)
    ms = []
    for _ in range(3):
        _p21_sync(dev)
        t0 = time.perf_counter()
        for i in range(window):
            run(i)
        _p21_sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0) / window)
    t0 = time.perf_counter()
    run(0)
    _p21_sync(dev)
    wall = 1e3 * (time.perf_counter() - t0)
    busy = (_p21_busy_ms(lambda: run(0))
            if dev.type == "cuda" else None)
    out[tag] = {"ms": sorted(ms)[1], "windows": ms, "wall_ms": wall,
                "busy_ms": busy}


def _p21_one_device(mesh, fn):
    """``fn()`` on rank 0 alone while the other ranks wait (no collective,
    the card to itself) -> its result on rank 0, None elsewhere."""
    from idealnerf_tpu_torch.parallel.launch import wait_for_ranks

    out = fn() if mesh.is_main else None
    wait_for_ranks(mesh)
    return out


def _p21_nccl(mesh, hw: int, rays: int, window: int) -> dict:
    """21a, the rank of a 1 x 1 NCCL mesh: P21_STEPS sharded head steps
    against HeadTrainer's from the same seed, then both timed."""
    import torch

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.parallel import ShardedHeadTrainer
    from idealnerf_tpu_torch.train.head import HeadTrainer

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           N_rand=rays)
    ds = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=76)
    one = HeadTrainer(cfg, ds, seed=0, device=mesh.device)
    sh = ShardedHeadTrainer(cfg, ds, mesh, seed=0)
    step_one, step_sh = one._step_fn(False), sh._step_fn(False)
    launches = _P21Launches()
    losses = []
    for i in range(P21_STEPS):
        m1 = step_one(one.state, one.data, i % 2, one.generator)
        with launches:
            m2 = step_sh(sh.state, sh.data, [i % 2], sh.generator)
        losses.append((float(m1["loss"]), float(m2["loss"])))
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        one.state.trainable(), sh.state.trainable()))
    out = {"rank": (mesh.rank, mesh.backend, str(mesh.device)),
           "losses": losses, "max_param_diff": diff}
    _p21_timed(lambda i: step_one(one.state, one.data, i % 2,
                                  one.generator), "one_step", out,
               mesh.device, window)
    _p21_timed(lambda i: step_sh(sh.state, sh.data, [i % 2], sh.generator),
               "mesh_step", out, mesh.device, window)
    out["launches"] = launches.total
    return out


def _p21_gloo(mesh, hw: int, rays: int, crop: int, window: int) -> dict:
    """21b, a rank of the 1 x 2 gloo mesh on the one card (and of a 2 x 1
    mesh over the same ranks): the head and torso gradients of both
    layouts, the 450² frame and composite and the crop-256 second-stage
    gradients with the aux terms, each against one device's on rank 0 on
    the same draws and weights; then the mesh's steps and frames timed
    beside one device's."""
    import argparse

    import torch

    from idealnerf_tpu_torch.cli.train_second_stage import build_aux_loss
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.renderer import (
        make_composite_frame_renderer, make_frame_renderer,
    )
    from idealnerf_tpu_torch.models.face_unet import ieee_convs
    from idealnerf_tpu_torch.parallel import sharded
    from idealnerf_tpu_torch.parallel.mesh import make_mesh
    from idealnerf_tpu_torch.train.head import (
        make_frame_loss, make_head_sampler, make_head_train_step,
    )
    from idealnerf_tpu_torch.train.second_stage import (
        TILE, make_cross_identity_dataset, make_second_stage_loss,
    )
    from idealnerf_tpu_torch.train.state import init_train_state
    from idealnerf_tpu_torch.train.torso import (
        TorsoState, make_torso_frame_loss, make_torso_optimizer,
        make_torso_sampler, torso_signal,
    )

    dev = mesh.device
    layouts = {"1x2": mesh, "2x1": make_mesh(2, 1, device=dev)}
    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                           N_rand=rays)
    ds = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=76,
                                with_torso=True)
    data = ds.to_device(dev)
    launches = _P21Launches()
    out = {"rank": (mesh.rank, mesh.backend, str(dev)), "gaps": {},
           "losses": {}}

    def gen(seed=7):
        return torch.Generator(device=dev).manual_seed(seed)

    # the head gradients of one step, each layout against one device
    for tag, m in layouts.items():
        st = init_train_state(cfg, ds.size, torch.Generator().manual_seed(0),
                              dev)
        idx = list(range(m.n_data))
        with launches:
            got = sharded.make_sharded_grads(cfg, ds, m)(st, data, idx,
                                                         gen())
        grads = _p21_grads(st.trainable())

        def head_ref():
            _p21_zero(st.trainable())
            g, sample = gen(), make_head_sampler(cfg, hw, hw, device=dev)
            loss_fn, total = make_frame_loss(cfg, ds, False, dev), 0.0
            for i in idx:
                loss, _ = loss_fn(st.params, st.latent_codes, data, i,
                                  sample(g, data, i), g)
                (loss / len(idx)).backward()
                total += float(loss.detach()) / len(idx)
            return total, _p21_grads(st.trainable())

        ref = _p21_one_device(m, head_ref)
        if ref is not None:
            out["gaps"][f"head {tag}"] = _p21_gap(
                grads, ref[1], _p21_names(st.params))
            out["losses"][f"head {tag}"] = (float(got["loss"]), ref[0])

    # the torso gradients, both layouts
    head = init_train_state(cfg, ds.size, torch.Generator().manual_seed(0),
                            dev)
    for tag, m in layouts.items():
        tp, _ = _torso_setup(cfg, dev)
        tst = TorsoState(0, tp, make_torso_optimizer(cfg, tp))
        idx = list(range(m.n_data))
        with launches:
            got = sharded.make_sharded_torso_grads(cfg, ds, m)(
                tst, head.params, head.latent_codes.detach(), data, idx,
                gen())
        grads = _p21_grads(tst.trainable())

        def torso_ref():
            _p21_zero(tst.trainable())
            g, sample = gen(), make_torso_sampler(cfg, hw, hw, dev)
            loss_fn, total = make_torso_frame_loss(cfg, ds, True, dev), 0.0
            for i in idx:
                loss, _ = loss_fn(tp, head.params, head.latent_codes.detach(),
                                  data, i, sample(g), g)
                (loss / len(idx)).backward()
                total += float(loss.detach()) / len(idx)
            return total, _p21_grads(tst.trainable())

        ref = _p21_one_device(m, torso_ref)
        if ref is not None:
            out["gaps"][f"torso {tag}"] = _p21_gap(
                grads, ref[1], [n for n, _ in tp.named_parameters()])
            out["losses"][f"torso {tag}"] = (float(got["loss"]), ref[0])
        del tp, tst

    # the 450² frame and the composite, ray-sharded over 1 x 2
    ncfg, (tp, tcfg) = cfg.face_nerf_config(), _torso_setup(cfg, dev)
    view = (hw, hw, ds.focal, ds.near, ds.far, cfg.render_config())
    where = dict(cx=ds.cx, cy=ds.cy)
    tile = min(8192, hw * hw)  # as render_val and eval_reenact tile it
    tile -= tile % mesh.n_ray
    pose, pose0 = (torch.from_numpy(ds.poses[i]).to(dev) for i in (1, 0))
    bc = data["bc_img"].float() / 255.0
    cond = (torch.randn(64, generator=torch.Generator().manual_seed(2))
            .to(dev), data["exprs"][1], torch.ones(32, device=dev))
    sig = torso_signal(cond[0], pose, cfg.dim_aud_body)
    frame = sharded.make_sharded_frame_renderer(ncfg, mesh, *view, **where,
                                                tile=tile)
    comp = sharded.make_sharded_composite_renderer(ncfg, tcfg, mesh, *view,
                                                   **where, tile=tile)
    one_frame = make_frame_renderer(ncfg, *view, **where)
    one_comp = make_composite_frame_renderer(ncfg, tcfg, *view, **where)
    with launches:
        f = frame(head.params, pose, bc, *cond)
        c = comp(head.params, tp, pose, pose0, bc, cond[0], sig, *cond[1:])
    ref = _p21_one_device(mesh, lambda: (
        one_frame(head.params, pose, bc, *cond),
        one_comp(head.params, tp, pose, pose0, bc, cond[0], sig,
                 *cond[1:])))
    if ref is not None:
        out["frame_err"] = float((f - ref[0]).abs().max())
        out["composite_err"] = float((c - ref[1]).abs().max())
    out["frame_finite"] = bool(torch.isfinite(f).all()
                               and torch.isfinite(c).all())

    # the crop-256 second stage with the aux terms over 1 x 2
    aux = build_aux_loss(argparse.Namespace(fan_npz=None, **AUX_WEIGHTS),
                         dev)
    # both sides tile the crop (a crop of one tile renders untiled on one
    # device, from other draws): 8 tiles of 8,192 rays at crop 256
    crop_tile = min(TILE, crop * crop // 2)
    sds = make_cross_identity_dataset(ds, ds.auds)
    sdata = sds.to_device(dev)
    st = init_train_state(cfg, sds.size, torch.Generator().manual_seed(0),
                          dev)
    with launches:
        loss, parts = make_second_stage_loss(cfg, sds, crop, aux_loss=aux,
                                             tile=crop_tile, device=dev,
                                             mesh=mesh)(
            st.params, st.latent_codes, sdata, 1, gen(9))
        with ieee_convs():  # as the step runs the aux nets' backward
            loss.backward()
    mse, aux_total = sharded.all_reduce_gradients(
        st.trainable(), (parts["mse_loss"], parts["aux_loss"]))
    grads = _p21_grads(st.trainable())

    def crop_ref():
        _p21_zero(st.trainable())
        loss, parts = make_second_stage_loss(cfg, sds, crop, aux_loss=aux,
                                             tile=crop_tile, device=dev)(
            st.params, st.latent_codes, sdata, 1, gen(9))
        with ieee_convs():
            loss.backward()
        return (float(loss.detach()), float(parts["aux_loss"].detach()),
                _p21_grads(st.trainable()))

    ref = _p21_one_device(mesh, crop_ref)
    if ref is not None:
        out["gaps"]["second stage 1x2"] = _p21_gap(
            grads, ref[2], _p21_names(st.params))
        out["losses"]["second stage 1x2"] = (float(mse + aux_total), ref[0])
        out["aux"] = (float(aux_total), ref[1])
    del st, sds, sdata, grads, aux
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # times: the mesh's step and frame beside one device's (rank 0 alone)
    tst = init_train_state(cfg, ds.size, torch.Generator().manual_seed(0),
                           dev)
    g = gen()
    for tag, m in layouts.items():
        step = sharded.make_sharded_train_step(cfg, ds, m)
        idx = list(range(m.n_data))
        _p21_timed(lambda i: step(tst, data, idx, g), f"{tag} step", out,
                   dev, window)
    one_step = make_head_train_step(cfg, ds, False, device=dev)
    _p21_one_device(mesh, lambda: _p21_timed(
        lambda i: one_step(tst, data, i % 2, g), "one step", out, dev,
        window))
    _p21_timed(lambda i: frame(head.params, pose, bc, *cond), "1x2 frame",
               out, dev, window)
    _p21_one_device(mesh, lambda: _p21_timed(
        lambda i: one_frame(head.params, pose, bc, *cond), "one frame", out,
        dev, window))
    out["launches"] = launches.total
    return out


def _phase_multi(args, p3_frames, dev: str = "cuda", hw: int = 450,
                 rays: int = 2048, crop: int = 256,
                 window: int = P21_WINDOW) -> dict:
    """Phase 21: multi-device (A13) on the one card. 21a: one rank through
    NCCL (a 1 x 1 mesh): P21_STEPS sharded head steps against
    HeadTrainer's from the same seed (450², N_rand 2048). 21b: two ranks
    on cuda:0 through gloo, spawned once: the head and torso gradients of
    a 1 x 2 and a 2 x 1 step, the ray-sharded 450² frame and composite,
    and the crop-256 second stage with the aux terms, each against one
    device's (frames P21_FRAME_TOL, gradients P21_GRAD_TOL); the steps and
    the frame timed beside one device's, with the card's idle share (the
    ranks' busy ms over rank 0's wall). 21c: train_head and render_val
    with --ray_devices 2 from their entry points, render_val's frames
    against phase 3's. The K1, K2, K4 and K6 launches of the mesh paths
    (the ranks' own counts) go into the kernels line; each rank's backend
    and device are asserted."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli import render_val, train_head
    from idealnerf_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    n_gpu = torch.cuda.device_count() if cuda else 1
    out, counts = {}, {k: 0 for k in P21_KERNELS}

    # 21a: one rank through NCCL
    t0 = time.perf_counter()
    (a,) = launch(_p21_nccl, 1, 1, device=dev, args=(hw, rays, window),
                  timeout=600)
    if a["rank"] != (0, "nccl" if cuda else "gloo", "cuda:0" if cuda
                     else "cpu"):
        raise AssertionError(f"21a rank got {a['rank']}")
    print(f"phase 21a 1 x 1 mesh through NCCL ({a['rank']}): "
          f"{P21_STEPS} sharded head steps against HeadTrainer's, losses "
          + ", ".join(f"{x:.6f}/{y:.6f}" for x, y in a["losses"])
          + f", max parameter difference {a['max_param_diff']:.3e}; "
          f"{a['one_step']['ms']:.2f} ms a step on one device, "
          f"{a['mesh_step']['ms']:.2f} on the mesh; launches "
          f"{a['launches']} ({time.perf_counter() - t0:.1f} s)")
    if a["max_param_diff"] > P21_FRAME_TOL:
        raise AssertionError("21a: the 1 x 1 mesh trained otherwise than "
                             "HeadTrainer")
    out["21a"] = a

    # 21b: two ranks on the one card through gloo
    t0 = time.perf_counter()
    ranks = launch(_p21_gloo, 1, 2, device=dev,
                   args=(hw, rays, crop, window), timeout=900)
    want = [(r, "gloo" if n_gpu < 2 else "nccl",
             f"cuda:{r % n_gpu}" if cuda else "cpu") for r in range(2)]
    if [r["rank"] for r in ranks] != want:
        raise AssertionError(f"21b ranks got {[r['rank'] for r in ranks]}, "
                             f"want {want}")
    b = ranks[0]
    for tag, (gap, worst) in b["gaps"].items():
        got, ref = b["losses"][tag]
        print(f"phase 21b {tag}: gradients {gap:.3e} norm-relative from one "
              f"device's at worst ({worst}; tol {P21_GRAD_TOL:g}), loss "
              f"{got:.6f} against {ref:.6f}")
        if not gap <= P21_GRAD_TOL or not math.isfinite(got):
            raise AssertionError(f"21b {tag}: the mesh's gradients differ")
    print(f"  second stage aux term {b['aux'][0]:.6f} on the mesh against "
          f"{b['aux'][1]:.6f} on one device")
    print(f"  450² frame {b['frame_err']:.3e}, composite "
          f"{b['composite_err']:.3e} from one device's (tol "
          f"{P21_FRAME_TOL:g})")
    if not (b["frame_finite"] and b["frame_err"] <= P21_FRAME_TOL
            and b["composite_err"] <= P21_FRAME_TOL):
        raise AssertionError("21b: the ray-sharded frame differs")
    times = {}
    for tag in ("1x2 step", "2x1 step", "one step", "1x2 frame",
                "one frame"):
        t = b[tag]
        busy = [r[tag]["busy_ms"] for r in ranks if tag in r]
        # where the ranks' kernels overlap on the card each one's duration
        # counts the other's time too: a busy sum past the wall says so
        idle = (None if None in busy
                else max(0.0, 1.0 - sum(busy) / t["wall_ms"]))
        times[tag] = {**t, "busy_ms_ranks": busy, "idle_share": idle}
        print(f"  {tag}: {t['ms']:.2f} ms (windows "
              f"{', '.join(f'{x:.2f}' for x in t['windows'])}), device busy "
              + " + ".join(_num(x, '.2f', ' ms') for x in busy)
              + f", idle share {_num(idle, '.3f')}")
    sum_counts = {k: sum(r["launches"][k] for r in ranks)
                  for k in P21_KERNELS}
    print(f"  launches on the mesh's paths (both ranks): {sum_counts} "
          f"({time.perf_counter() - t0:.1f} s)")
    out["21b"] = {"ranks": [r["rank"] for r in ranks], "gaps": b["gaps"],
                  "losses": b["losses"], "aux": b["aux"],
                  "frame_err": b["frame_err"],
                  "composite_err": b["composite_err"], "times": times,
                  "launches": sum_counts}

    # 21c: the CLIs' --ray_devices from their entry points
    t0 = time.perf_counter()
    base = "output/chip_smoke_mesh"
    shutil.rmtree(base, ignore_errors=True)
    reset = [m.reset_launch_counts for m in _p21_modules()]
    for r in reset:
        r()
    res = train_head.main([
        "--synthetic", "2", "--synthetic_hw", str(hw), *PAPER_FLAGS,
        "--N_rand", str(rays), "--epochs", "2", "--i_print", "1",
        "--device", dev, "--basedir", base, "--expname", "head",
        "--ray_devices", "2"])
    th = _p21_counts()
    steps = res["step"]
    print(f"phase 21c train_head --ray_devices 2: {steps} steps, losses "
          + ", ".join(f"{m['loss']:.5f}" for _, m in res["history"])
          + f"; launches {th}")
    if not (steps == 4 and all(math.isfinite(m["loss"])
                               for _, m in res["history"])):
        raise AssertionError("21c train_head on the mesh failed")
    if cuda and (th[K4] != 2 * 2 * steps or th[K6] != 2 * 2 * steps):
        raise AssertionError(f"21c train_head launched {th}")
    for r in reset:
        r()
    rv = render_val.main([
        "--synthetic", str(args.frames), "--synthetic_hw", str(args.hw),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--device", dev, "--save_path", base, "--ray_devices", "2"])
    rc = _p21_counts()
    err = float(np.abs(rv["frames"] - p3_frames).max())
    print(f"phase 21c render_val --ray_devices 2: {args.frames} frames of "
          f"{args.hw}², {rv['frame_ms']:.1f} ms/frame, PSNR "
          f"{rv['psnr']:.3f}, {err:.3e} from phase 3's frames (tol "
          f"{P21_FRAME_TOL:g}); launches {rc} "
          f"({time.perf_counter() - t0:.1f} s)")
    if err > P21_FRAME_TOL:
        raise AssertionError("21c render_val on the mesh differs from "
                             "phase 3")
    for k in ("fused_render_rays", "fused_render_coarse_hier"):
        if cuda and rc[k] != 2 * args.frames:
            raise AssertionError(f"21c render_val launched {rc}")
    out["21c"] = {"train_head": {"steps": steps, "launches": th,
                                 "history": res["history"]},
                  "render_val": {"frame_ms": rv["frame_ms"],
                                 "psnr": rv["psnr"], "max_err": err,
                                 "launches": rc}}
    for part in (a["launches"], sum_counts, th, rc):
        for k in P21_KERNELS:
            counts[k] += part[k]
    idle = [k for k, n in counts.items() if not n > 0]
    if cuda and idle:
        raise AssertionError(f"phase 21: not launched on the mesh: {idle}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21 multi-device: {out['seconds']:.1f} s; launches on the "
          f"mesh's paths {counts}")
    return out


def _p21_modules():
    from idealnerf_tpu_torch.kernels import fused_mlp, fused_mlp_grad
    from idealnerf_tpu_torch.kernels import fused_render

    return fused_render, fused_mlp, fused_mlp_grad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--hw", type=int, default=450)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--points", type=int, default=2048 * (64 + 192))
    ap.add_argument("--train_hw", type=int, default=450)
    ap.add_argument("--train_frames", type=int, default=4)
    ap.add_argument("--train_epochs", type=int, default=5)
    ap.add_argument("--serve_frames", type=int, default=30)
    ap.add_argument("--only_widths", action="store_true",
                    help="the build and phase 12d alone (a quick check of "
                         "the width instances; prints no result)")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from idealnerf_tpu_torch.cli import render_val
        from idealnerf_tpu_torch.config import ExperimentConfig
        from idealnerf_tpu_torch.core.rays import get_rays
        from idealnerf_tpu_torch.core.sampling import stratified_sample
        from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
        from idealnerf_tpu_torch.eval.renderer import (
            foreground_prior, make_frame_renderer,
        )
        from idealnerf_tpu_torch.eval.temporal import _prior_sel
        from idealnerf_tpu_torch.kernels import build as kbuild
        from idealnerf_tpu_torch.kernels import fused_mlp as fm
        from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
        from idealnerf_tpu_torch.kernels import fused_render as fr
        from idealnerf_tpu_torch.models.face_nerf import (
            FaceNeRF, fold_conditioning,
        )
        from idealnerf_tpu_torch.train.state import init_params
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    report = {"device": kind, "nvidia_smi": smi, "cuda": torch.version.cuda,
              "torch": torch.__version__}

    # ---- phase 1: device + build
    t0 = time.perf_counter()
    info = kbuild.build()
    kbuild.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "Function properties" in ln or "C7511" in ln
             or "nvcc seconds" in ln]
    report.update(build_seconds=build_s, ptxas=ptxas)
    print(f"phase 1 device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {smi} | kernels built in "
          f"{build_s:.1f} s (nvcc {info['seconds']:.1f} s)")
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    if args.only_widths:
        res = _phase_widths(fr, fm, fmg, ptxas, keep_going=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "widths.json"), "w") as fh:
            json.dump(res, fh, indent=1)
        return 0

    # ---- phase 2: kernels vs plain versions at main-path shapes
    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32)
    ncfg = cfg.face_nerf_config()
    gen = torch.Generator().manual_seed(0)
    nets = {k: FaceNeRF(ncfg, gen).to(dev) for k in ("coarse", "fine")}
    aud = torch.randn(64, generator=gen).to(dev)
    expr = torch.randn(76, generator=gen).to(dev)
    latent = torch.ones(32, device=dev)
    ds = make_synthetic_dataset(n_frames=1, H=450, W=450, dim_expr=76)
    ro, rd = get_rays(450, 450, ds.focal, torch.from_numpy(ds.poses[0]).to(dev),
                      ds.cx, ds.cy)
    bc = (torch.from_numpy(ds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    frame = tuple(x.reshape(-1, 3).contiguous() for x in (ro, rd, bc))
    pick = torch.linspace(0, 450 * 450 - 1, args.rays).long().to(dev)
    ro, rd, bc = (x[pick].contiguous() for x in frame)
    near, far, n_s, n_i = ds.near, ds.far, cfg.N_samples, cfg.N_importance
    errs = {k: 0.0 for k in KERNELS}

    def fold(net, c):
        return fold_conditioning(net, c, aud, expr, latent)

    def check(tag, c, rays, s_c=n_s, s_i=n_i):
        o, d, b = ro[:rays], rd[:rays], bc[:rays]
        fc, ff = fold(nets["coarse"], c), fold(nets["fine"], c)
        ck, zk = fr.fused_render_coarse_hier(nets["coarse"], fc, c, o, d, b,
                                             near, far, s_c, s_i)
        cp, _ = fr.fused_render_coarse_hier_reference(
            nets["coarse"], fc, c, o, d, b, near, far, s_c, s_i)
        lc = {k: fr.render_launch_config(*a) for k, a in
              (("coarse", (s_c, s_i)), ("fine", (s_c + s_i,)))}
        print(f" fused_render_coarse_hier [{tag}, R={rays}, {s_c}+{s_i}]: "
              + _plan_text(lc["coarse"]))
        e = [_agree(k, ck[k], cp[k], corr=k == "rgb_map") for k in
             ("rgb_map", "acc_map", "weights", "last_weight")]
        zc = stratified_sample(near, far, s_c, rays, device=dev)
        e.append(_agree("z_all vs plain merge of the kernel's weights", zk,
                        fr.importance_depths(zc, ck["weights"], s_i),
                        atol=Z_ATOL))
        errs["fused_render_coarse_hier"] = max(
            errs["fused_render_coarse_hier"], *e)
        fk = fr.fused_render_rays(nets["fine"], ff, c, o, d, zk, b)
        fp = fr.fused_render_rays_reference(nets["fine"], ff, c, o, d, zk, b)
        print(f" fused_render_rays [{tag}, R={rays}, S={s_c + s_i}]: "
              + _plan_text(lc["fine"]))
        e = [_agree(k, fk[k], fp[k], corr=k == "rgb_map") for k in
             ("rgb_map", "acc_map", "weights", "last_weight")]
        errs["fused_render_rays"] = max(errs["fused_render_rays"], *e)
        torch.cuda.synchronize()
        return fc, ff, zk

    print("phase 2 kernels vs plain versions")
    fc, ff, zk = check("relu", ncfg, args.rays)
    sp = dataclasses.replace(ncfg, density_activation="softplus")
    check("softplus, ragged", sp, min(1001, args.rays))
    # a power-of-two union, where the TPU kernel's merge had no filler
    check("relu, ragged", ncfg, min(1001, args.rays), 16, 16)

    res2 = _phase_frame(fr, nets, fc, ff, ncfg, near, far, n_s, n_i,
                        {"phase-2 rays": (ro, rd, bc), "450x450 frame": frame},
                        ptxas, info["path"])
    report["frame_kernels"] = res2
    del frame
    torch.cuda.empty_cache()
    for k in res2["450x450 frame"]:
        errs[k] = max(errs[k], max(res2[t][k]["max_abs_err"]
                                   for t in ("phase-2 rays", "450x450 frame")))

    # ---- phase 3: the slice through its CLI entry point
    fr.reset_launch_counts()
    res = render_val.main([
        "--synthetic", str(args.frames), "--synthetic_hw", str(args.hw),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--device", "cuda", "--save_path", "output/chip_smoke"])
    counts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                               "fused_render_rays")}
    print(f"phase 3 render_val: {args.frames} frames of {args.hw}x{args.hw}, "
          f"D=8 W=256 {n_s}+{n_i}: {res['frame_ms']:.1f} ms/frame after the "
          f"first, PSNR {res['psnr']:.3f}, SSIM {res['ssim']:.4f}, "
          f"launches {counts}")
    # the report keeps the metrics only; phase 21 holds its ray-sharded
    # render_val against these frames
    p3_frames = res.pop("frames")
    if not (math.isfinite(res["psnr"]) and math.isfinite(res["ssim"])
            and p3_frames.shape == (args.frames, args.hw, args.hw, 3)):
        raise AssertionError("render_val produced non-finite frames")
    for k, n in counts.items():
        if n != args.frames:
            raise AssertionError(f"{k} launched {n} times for "
                                 f"{args.frames} frames")
    report.update(render_val=res, launches=counts)

    # ---- phase 4: a small frame, card vs plain versions on the host
    st = init_params(cfg, 1, torch.Generator().manual_seed(1))
    sds = make_synthetic_dataset(n_frames=1, H=24, W=24, dim_expr=76)
    render = make_frame_renderer(ncfg, 24, 24, sds.focal, sds.near, sds.far,
                                 cfg.render_config(), cx=sds.cx, cy=sds.cy)
    frames = {}
    for d in ("cpu", "cuda"):
        p = st.params.to(d)
        a = torch.randn(64, generator=torch.Generator().manual_seed(2)).to(d)
        e = torch.from_numpy(sds.exprs[0]).to(d)
        frames[d] = render(p, torch.from_numpy(sds.poses[0]).to(d),
                           torch.from_numpy(sds.bc_img).to(d).float() / 255,
                           aud=a, expr=e, latent=torch.ones(32, device=d))
    print("phase 4 24x24 frame, card vs plain versions on the host")
    report["frame_24_err"] = _agree("frame", frames["cuda"].cpu(),
                                    frames["cpu"], corr=True)

    # ---- where a frame's time goes (torch.profiler)
    render = make_frame_renderer(ncfg, 450, 450, ds.focal, near, far,
                                 cfg.render_config(), cx=ds.cx, cy=ds.cy)
    report["profile"] = _profile(
        lambda: render(nets, torch.from_numpy(ds.poses[0]).to(dev),
                       torch.from_numpy(ds.bc_img).to(dev).float() / 255,
                       aud=aud, expr=expr, latent=latent),
        "450x450 frame", "profile_frame.txt")

    # ---- phases 6 and 7: the training kernels at the step's shapes; the
    # points lie on the phase-2 rays at uniform depths in [near, far]
    pts, dirs = _points(ro, rd, near, far, args.points)
    res6 = _phase_point_mlp(fm, fr, nets["fine"], ff, ncfg, pts, dirs, ptxas,
                            info["path"])
    res7 = _phase_grad(nets["coarse"], ncfg, (aud, expr, latent), pts, dirs,
                      ptxas, info["path"])
    report.update(point_mlp=res6, point_mlp_grad=res7)
    del pts, dirs
    torch.cuda.empty_cache()

    # ---- phase 8: the training slice through its CLI entry point
    res8 = _phase_train(args, fm, fmg, fr)
    report["train"] = res8
    report["profile_train_step"] = _profile_train_step(args)

    # ---- phases 9 and 10: the serving slice on the synthetic subject whose
    # foreground prior holds 129,024 rays of the 450x450 frame
    sds = make_synthetic_dataset(n_frames=args.serve_frames, H=450, W=450,
                                 dim_expr=76)
    mask, _ = foreground_prior(sds)
    sel = torch.from_numpy(_prior_sel(mask, 450 * 450)).long().to(dev)
    po, pd = get_rays(450, 450, sds.focal,
                      torch.from_numpy(sds.poses[0]).to(dev), sds.cx, sds.cy)
    pb = (torch.from_numpy(sds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    prior = tuple(x.reshape(-1, 3)[sel].contiguous() for x in (po, pd, pb))
    res9 = _phase_delta(fr, nets, fold, ncfg, near, far, n_s, n_i, ro, rd,
                        bc, prior, ptxas)
    del prior, po, pd, pb
    torch.cuda.empty_cache()
    res10 = _phase_serve(fr, nets, ncfg, (aud, expr, latent), sds, mask)
    report.update(delta=res9, serve=res10)
    del sds, mask, sel
    torch.cuda.empty_cache()

    # ---- phase 11: K5 and the kernel-diagnosis probes (K7)
    pts, dirs = _points(ro, rd, near, far, args.points)
    res11 = _phase_k5(fm, fr, nets["fine"], ff, ncfg, pts, dirs)
    probes = _phase_kdiag(
        fm, fr, pts, dirs, args.rays,
        render_lib=res2["phase-2 rays"]["fused_render_rays"]["library_ms"],
        ptxas=ptxas, so_path=info["path"])
    report.update(k5=res11, kdiag=probes)
    del pts, dirs
    torch.cuda.empty_cache()
    report["kframe"] = _phase_kframe()
    report["kpoint"] = _phase_kpoint()

    # ---- phase 12: the head + torso composite and C1
    frame = tuple(x.reshape(-1, 3).contiguous() for x in get_rays(
        450, 450, ds.focal, torch.from_numpy(ds.poses[0]).to(dev), ds.cx,
        ds.cy)) + ((torch.from_numpy(ds.bc_img).to(dev).float() / 255.0)
                   .reshape(-1, 3),)
    res12a = _phase_torso_field(fr, cfg, nets, (aud, expr, latent), ds,
                                {"phase-2 rays": (ro, rd, bc),
                                 "450x450 frame": frame})
    del frame
    torch.cuda.empty_cache()
    res12b = _phase_torso_train(args, fm, fmg, res8["ckpt_dir"])
    res12c = _phase_reenact(args, fr, res8["ckpt_dir"], res12b["ckpt_dir"])
    res12e = _phase_temporal_composite(args, fr, res8["ckpt_dir"],
                                       res12b["ckpt_dir"],
                                       res12c.pop("frame0"))
    res12d = _phase_widths(fr, fm, fmg, ptxas)
    report.update(torso_field=res12a, torso_train=res12b, reenact=res12c,
                  widths=res12d, temporal_composite=res12e)

    # ---- phase 13: the real-subject path, and the 450x450 JAX fixture
    res13 = _phase_subject(args, fm, fmg, fr)
    res13f = _phase_fixture(fr)
    report.update(subject=res13, fixture=res13f)

    # ---- phase 14: the per-frame fast modes and the depth-band probes
    res14 = _phase_fast(args, fr, res8["ckpt_dir"], res12b["ckpt_dir"], res13)
    report["fast"] = res14

    # ---- phase 15: the gate harness and the gated operating points
    res15 = _phase_gates(fr, fm, fmg)
    report["gates"] = res15

    # ---- phase 16: the exact-f32 training path (train_fused 1)
    res16 = _phase_train_f32(args, fm, fmg, res8["ckpt_dir"])
    report["train_f32"] = res16

    # ---- phase 17: the measurement scripts
    res17 = _phase_measure(res8["ckpt_dir"], res15)
    report["measure"] = res17

    # ---- phase 18: the variants, the baseline, the second stage, the UNet
    res18 = _phase_variants(args, fm, fmg, fr, res8["ckpt_dir"])
    report["variants"] = res18

    # ---- phase 19: the second stage's aux losses (A11)
    res19 = _phase_aux(args, fm, fmg, fr, res8["ckpt_dir"],
                       res18["second_stage"], res15, smi)
    report["aux"] = res19

    # ---- phase 20: the offline pipeline (A12) through to a trained head
    res20 = _phase_pipeline(fm, fmg, fr, smi)
    report["pipeline"] = res20

    # ---- phase 21: multi-device (A13): ranks on the one card
    res21 = _phase_multi(args, p3_frames, hw=args.train_hw)
    report["multi"] = res21

    # launches on the main paths: render_val and the composite reenact
    # (K1, K2), train_head and train_torso (K4, K6), serve head-only and
    # composite (K3)
    for k, n in res12c["launches"].items():
        counts[k] += n
    for k, n in res8["launches"].items():
        counts[k] = n + res12b["launches"][k]
    counts["fused_render_delta"] = sum(
        r["launches"]["fused_render_delta"]
        for r in (res10["defaults"], res12e["serve defaults"]))
    # and the real-subject path: render_val, eval_reenact, serve (K1-K3),
    # train_head and train_torso (K4, K6)
    for part in ("render_val", "reenact", "serve"):
        for k, n in res13[part]["launches"].items():
            if k in counts:
                counts[k] += n
    for part in ("train_head", "train_torso"):
        for k in ("fused_point_mlp", "fused_point_mlp_grad"):
            counts[k] += res13[part]["launches"][k]
    # and the fast modes' frames and CLIs (K1, K2)
    for k, n in res14["launches"].items():
        counts[k] += n
    # and the gate harness: its training (K4, K6), sweep, clips and the
    # --auto_temporal runs (K1-K3)
    for k in counts:
        counts[k] += res15["launches"].get(k, 0)
    for k, e in res12a["errs"].items():
        errs[k] = max(errs[k], e)
    errs.update(fused_point_mlp=res6["max_abs_err"],
                fused_point_mlp_grad=res7["max_abs_err"],
                fused_render_delta=max(res9["max_abs_err"],
                                       res12e["errs"]["fused_render_delta"]))
    errs["fused_render_rays"] = max(errs["fused_render_rays"],
                                    res12e["errs"]["fused_render_rays"])
    for k, e in res14["errs"].items():
        errs[k] = max(errs[k], e)
    # the frame's kernels at their path's launch shape, a whole frame
    frame_res = res2["450x450 frame"]
    times = {k: (r["ms"], r["plain_ms"]) for k, r in frame_res.items()}
    f32 = res7[f"f32_{args.points}"]
    times.update(fused_point_mlp=(res6["ms"], res6["plain_ms"]),
                 fused_point_mlp_grad=(res7["ms"], res7["plain_ms"]),
                 grad_pass_a_f32=(f32["pass_a_ms"], f32["pass_a_plain_ms"]),
                 grad_pass_b_f32=(f32["pass_b_ms"], f32["pass_b_plain_ms"]),
                 fused_render_delta=(res9["ms"], res9["plain_ms"]))
    # the f32 passes' launches on their path: phase 16's train_head run
    for k in ("grad_pass_a_f32", "grad_pass_b_f32"):
        counts[k] = res16["launches"][k]
    # and the measurement scripts' (K1-K4, K6), and phase 18's: the
    # variants' train_head, render_val and serve (K1-K4, K6), train_baseline
    # and train_second_stage (K4, K6, the f32 passes)
    for k in counts:
        counts[k] += res17["launches"].get(k, 0)
        counts[k] += res18["launches"].get(k, 0)
        counts[k] += res19["launches"].get(k, 0)
        counts[k] += res20["launches"].get(k, 0)
        counts[k] += res21["launches"].get(k, 0)
    errs.update(grad_pass_a_f32=max(f32["pass_a_err"],
                                    res7["pass_a_f32_1001_err"]),
                grad_pass_b_f32=f32["pass_b_err"])
    bounds = {
        **{k: {f: r[f] for f in ("bound_ms", "bound_by")}
           for k, r in frame_res.items()},
        "fused_point_mlp": {k: res6[k] for k in ("bound_ms", "bound_by")},
        "fused_point_mlp_grad": _point_bound(ncfg, args.points, True),
        "grad_pass_a_f32": f32["bound_a"], "grad_pass_b_f32": f32["bound_b"],
        "fused_render_delta": {k: res9[k] for k in ("bound_ms", "bound_by")},
    }
    # no single PyTorch call computes K1-K6; the library column of K1-K3 is
    # their MLP as torch.addmm calls, the chains' the same chain as
    # torch.matmul / torch._int_mm calls
    entries = {k: {"launches": counts[k], "max_abs_err": errs[k],
                   "ms": times[k][0], "plain_ms": times[k][1], **bounds[k],
                   "library_ms": None} for k in times}
    entries["fused_render_delta"]["library_ms"] = res9["library_ms"]
    entries["fused_point_mlp"]["library_ms"] = res6["library_ms"]
    for k, r in frame_res.items():
        entries[k]["library_ms"] = r["library_ms"]
    entries.update(probes["entries"])
    k5 = entries["fused_point_mlp_pe"]
    k5["max_abs_err"] = max(k5["max_abs_err"], res11["max_abs_err"])
    # and each kernel's instances at the other widths (phase 12d): their
    # time, plain version, bound, error and launches on that width's path
    for k in WIDTH_KERNELS:
        entries[k]["widths"] = {
            W: {f: r["kernels"][k][f] if f != "launches" else
                r["launches"].get(k, 0) for f in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                    "launches")}
            for W, r in res12d["widths"].items()}
    # the probes' entries also name the body they run
    kernels = [{"name": k, "route": "cuda", **KERNELS[k],
                **{f: entries[k][f] for f in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "body", "widths")
                   if f in entries[k]}}
               for k in KERNELS]
    idle = [e["name"] for e in kernels if not e["launches"] > 0]
    if idle:
        raise AssertionError(f"not launched on their paths: {idle}")
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_run
    print(f"chip_smoke: all phases in {report['seconds']:.1f} s, the build "
          f"included")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
