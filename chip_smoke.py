#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the final result line:

1. device  - a CUDA device is present; its name and power limit.
2. build   - the eight kernel sources compile with nvcc from csrc/
   (sm_90a), one nvcc process per source, all started together.
3. kernel A vs plain - bin_decode on the 100k bench cloud, one 800x800
   view: pair_tile, pair_particle and tile_start EQUAL to the plain
   PyTorch version; ms by CUDA events and device time (torch.profiler).
4. kernel B vs plain - raster_fwd on the same view and pairs: features,
   opacity and T_final within 1e-4, depth within 1e-3 relative, hit
   counts differing on < 1% of pixels; its cull's plain mirror and the
   fp32 exact test on the same inputs on the card
   (ops/cuda/raster.py:cull_plain): no culled candidate accepted, the
   share culled, the work it leaves (B's bound); its registers.
5. JAX values - render_gut against the JAX outputs saved in
   tests/fixtures/torch_port_gut_small.npz, at the CPU test tolerances.
6. serving slice - make_serving_renderer on the 100k cloud, 8 orbit
   views at 800x800, SH degree 3: both kernels' launch counters equal
   the number of views; outputs finite with real coverage; ms/frame.
7. oracle probe - 200x200, the first 60k particles, the port's oracle
   against render_gut: bulk >= 80 dB and flip_frac <= 0.01.
8. kernel C vs plain - raster_bwd on the phase-4 view with seeded random
   upstream gradients: per record field group (a, M, density, rgb)
   cosine >= 0.9999 and relative L2 <= 1e-3 against the float64
   autograd plain version, two runs bitwise equal; its registers, local
   and shared bytes (cudaFuncGetAttributes); its bound charges C's own
   work per composited candidate (BWD_ACCEPT_FLOPS).
9. kernel D vs plain - fold on kernel C's output as render_gut's
   backward calls it (the tile sort inverted by D's library, the culled
   rows past tile_start[-1] not read): max |diff| <= 1e-5 of max |ref|,
   and two runs bitwise equal; the inversion equal to its plain version;
   ms by events and device time, beside index_add_ (and argsort); D's
   bound charges the rows before the culled ones.
10. gradients vs JAX - render_gut's gradients of the six parameter
   leaves against tests/fixtures/torch_port_grad_small.npz:
   max-normalised error <= 2e-3 and cosine >= 0.9999.
11. train step - scripts/bench_train_torch.py's step (100k, 800x800,
   SH 3, L1 + DSSIM, Adam): 3 warm-up steps, then 20 timed steps in
   which kernels A-D launch 20 times each; loss finite; every parameter
   gradient finite and non-zero; ms/step and it/s.
12. trainer - Trainer from 100k random Gaussians (capacity headroom 4)
   on 8 teacher views at 800x800, 260 steps: densify grows the cloud,
   n_active changes, the mean train PSNR of steps 230-249 beats steps
   1-20 by >= 2 dB, the density reset at step 250 clamps every active
   density, and a checkpoint round trip repeats the next step's loss.

The 3DGRT and sorted-3DGUT path (sorted compositing: per-ray windows of
W candidates; render/grt.py):

The two sorted settings are those train_torch.py composes for
apps/nerf_synthetic_3dgrt (3DGRT: degree 4, min_transmittance 1e-3,
W = 16) and paper/3dgut/sorted_nerf_synthetic (sorted 3DGUT: degree 2,
min_transmittance 1e-4, W = 16), read from the sorted gradient fixture,
whose settings tests/test_torch_grt.py holds to the YAML.

13. sorted kernel B vs plain - raster_fwd on the phase-3 view and pairs
   with both sorted settings: the tolerances of phase 4, and phase 4's
   cull check; then 3DGRT serving, 8 views at 800x800 through
   make_serving_renderer (ms/frame).
14. sorted kernel C vs plain - raster_bwd at both settings against the
   float64 autograd plain version: cosine >= 0.9999 and relative L2
   <= 1e-3 per field group, and two runs bitwise equal; its resources.
15. kernel E vs plain - wmax (the blend-weight telemetry) on the same
   view, global-Z and both sorted settings: max |diff| <= 1e-6, two runs
   bitwise equal; its cull (B's) checked on each setting's inputs.
16. sorted gradients vs JAX - render_gut's gradients with both sorted
   settings against tests/fixtures/torch_port_grt_grad_small.npz:
   max-normalised error <= 2e-3 and cosine >= 0.9999.
17. 3DGRT and sorted-3DGUT train steps - phase 11's step with each sorted
   setting: 20 timed steps in which kernels A-D launch 20 times each (B
   and C in the sorted mode) and E never; ms/step; 5 traced steps:
   device busy, idle share and device kernels per step.
18. 3DGRT trainer - phase 12's run with the 3DGRT settings and weight
   pruning on (telemetry every 10 steps from step 100, a prune at 150):
   >= 2 dB, the weight prune drops particles, kernel E launched.

The rolling-shutter and fisheye path (the general-geometry mode of
kernels B, C and E, the TPU's kernel 5: a per-pixel ray origin; a
rolling-shutter camera takes it, a fisheye one the shared-origin mode):

19. general kernel B vs plain - the 100k cloud through the NCore-like
   1920x1280 rolling shutter of synthetic.py:bench_camera, 3DGUT
   (degree 2, W 0) and 3DGRT (degree 4, W 16): phase 4's tolerances,
   except on at most 8 kill-flip pixels (T within rounding of
   min_transmittance: one candidate more in one version, at most
   max_alpha * min_transmittance apart); and general B on those rays (all from the mid-shutter centre)
   against shared-origin B with the table built at that centre, within
   1e-4; phase 4's cull check.
20. general kernel C vs float64 plain - cosine >= 0.9999 and relative L2
   <= 1e-3 per field group (p, M, density, rgb), two runs bitwise equal;
   its resources; kernel D folds the result (phase 9's checks and
   timers), beside index_add_.
21. general kernel E vs plain - within 1e-6 (at most 8 pairs, those of
   kill-flip pixels, within max_alpha * min_transmittance), two runs
   bitwise equal; its cull is phase 19's (the same inputs).
22. general gradients vs JAX - both settings against
   tests/fixtures/torch_port_shutter_grad_small.npz: phase 10's
   tolerances.
23. train steps at full width - phase 11's step through the rolling
   shutter (3DGUT and 3DGRT settings: general B and C launch 20 times in
   20 steps, shared-origin B and C never, A and D 20 times) and through
   the ScanNet++-like 1752x1168 fisheye (shared-origin B and C 20 times);
   ms/step; 5 traced steps: device busy, idle share.
24. rolling-shutter trainer and serving - phase 12's run on 8 rolling
   teacher views at 1920x1280 with weight pruning on (general E
   launched): >= 2 dB, densify, prune and reset firing; then
   make_serving_renderer on 8 rolling and 8 fisheye orbit views: ms/frame,
   general (rolling) and shared-origin (fisheye) B launched once per view.
25. CLI - train_torch.py --config-name apps/scannetpp_3dgut on a
   generated 6-view fisheye ScanNet++ capture at 1752x1168 with COLMAP
   init, 30 steps: exit 0, checkpoint written.

The NHT path (kernel 8, the NHT modes of B and C: 64-float records, 24
ray features at the canonical hit; kernel D 64 wide), trained under the
MCMC strategy:

26. NHT kernel B vs plain - the 100k bench cloud with 48 NHT features
   drawn from the seed (synthetic.py:nht_cloud) through the 800x800
   pinhole, which NHT renders in the general mode, at degree 2 (3DGUT)
   and degree 4 (3DGRT, unsorted as NHT composites): phase 4's
   tolerances, kill flips counted as in phase 19; its resources.
27. NHT kernel C and 64-wide D vs plain - C at both degrees: cosine
   >= 0.9999 and relative L2 <= 1e-3 per field group (p, M, density, the
   48 features), two runs bitwise equal, the padding fields zero; its
   registers, local and shared bytes (cudaFuncGetAttributes); its sine
   and cosine within 1e-6 of float64 on 6M arguments of the fast path's
   range (|x| <= 2^20) and 1M past it; D on C's output
   within 1e-5 of max, two runs bitwise equal, by events and device
   time, beside index_add_.
28. NHT gradients vs JAX - render_gut's gradients of the five leaves
   against tests/fixtures/torch_port_nht_grad_small.npz: phase 10's
   tolerances.
29. NHT + MCMC train steps at full width -
   scripts/bench_train_torch.py's NHT step (100k, 800x800, the decoder
   and its EMA, MCMC perturb) with the render settings of
   apps/nerf_synthetic_3dgut_mcmc_nht, then apps/nerf_synthetic_3dgrt_
   mcmc_nht: 20 timed steps in which NHT B and C and the 64-wide D
   launch 20 times and no other mode of them; 5 traced steps.
30. NHT trainer - the apps/nerf_synthetic_3dgut_mcmc_nht trainer
   (train_torch.py's mapping and model) from 100k random Gaussians on 8
   teacher views at 800x800, 260 steps, with the warmup, color refine,
   relocate and add moved early and the EMA on: train PSNR of steps
   230-249 over steps 1-20 by >= 2 dB, fewer particles relocated than
   live at every relocate event, validate through the EMA decoder
   finite.

The trace() and playground path (render/grt.py:trace on arbitrary rays;
the shared-segment mode of kernels B and C, the TPU's kernel 7, for the
brute force; windows of 128 for both regimes; the normals mode of B):

31. kernel 7 B vs plain - trace's brute force over the 8192 slots of
   bench_cloud(8192) (SH 3) on the 512x512 orbit view's rays (1,024
   blocks of 256), windows of 128: phase 19's tolerances; its cull's
   plain mirror and the fp32 exact test on the same inputs on the card
   (ops/cuda/raster.py:cull_plain): no culled candidate accepted,
   the share culled; the k-buffer's overflow passes
   (common.cuh:g_window_overflows); the four trace instantiations'
   registers, local and shared bytes (cudaFuncGetAttributes).
32. kernel 7 C and D vs plain - C over the shared segment with seeded
   upstream gradients against the float64 plain backward on all 1,024
   blocks: phase 20's tolerances, two runs bitwise equal, its k-buffer
   overflow passes; D's shared-segment mode folds its 8.4M per-block
   rows (each slot's rows summed over the blocks, then the segment's
   fold) within 1e-5 of max of repeat_fold + the float64 plain fold,
   bitwise equal, by events and device time, beside index_add_, its
   bound on the rows of the owned slots, the segment's fold and the
   output; trace's sorted gradients
   against tests/fixtures/torch_port_trace_grad_small.npz (phase 10's
   tolerances); the trace path (forward and backward) launches kernel
   7's B and C and D once each; ms per trace call.
33. W 128 B and C vs plain - trace's grid over bench_cloud(100_000) on
   the same view (7,168 candidates a block): B at phase 19's tolerances,
   C on all 1,024 blocks at phase 20's, bitwise repeatable; D on C's
   rows through the inverse of the grid's own sort (phase 9's checks and
   timers; its bound on the rows some particle owns); phase 31's
   cull check and overflow passes; the trace path launches W 128 B and C
   and D once each and D's inversion never; ms per trace call.
34. normals - B's normals mode in the brute-force trace against plain
   (normals within 2e-3), and render_gut's normals against the port's
   oracle on phase 7's probe; one trace with normals launches it once.
35. grid vs brute force at 100k in rank order (_sorted=False): with
   every cell of the grid, 8 blocks composite the brute force's sequence
   (within 1e-5); the full frame with the defaults reports
   accel_overflow and the share of rays the grid covers; ms per call.
36. playground - playground_torch.py's engine over the 100k cloud with
   the demo primitives (glass icosphere, mirror box), 512x512, 3
   bounces, 1 spp: ms per frame, W 128 B launched 3 times a frame, 2
   traced frames (device busy, idle share, device kernels per frame),
   the frame finite and away from the envmap; the viewer on 127.0.0.1
   answers GET / and three frames, each a decodable 512x512 JPEG.

Kernels F, G and H (csrc/scatter_rows.cu, expand_rows.cu, fill.cu) and
the table-gradient raster route (ops/cuda/raster.py:rasterize_tiles_table:
B, C, then F summing the per-pair rows by particle id). The train step and
serving launch none of them:

37. kernel F vs plain - the row scatter on the 800x800 bench view's own
   pairs (kernel C's rows for phase 8's upstream gradients, by
   pair_particle, onto the 100k-row table): within 1e-6 of max of the
   float64 plain version, two runs bitwise equal and equal to F on the
   runs of a stable sort; ms with its set-up (a counting sort), of the
   set-up and of the kernel alone, beside index_add_, and the device
   time alone of F with its set-up, of the set-up and of index_add_
   (torch.profiler), and the share of runs the set-up leaves out of pair
   order;
   its kernels' registers, local and shared bytes.
38. table route - the bench view's raster forward and backward through
   rasterize_tiles_table in the 3DGUT and the 3DGRT (degree 4, W 16)
   setting: its image equal to the D route's, its table gradient within
   1e-5 of max and cosine >= 0.9999999 of the D route's; 20 steps launch
   B, C, F and F's set-up 20 times each and D never; host ms per step of
   both routes.
39. kernel G vs plain - the interval expansion equal bit for bit to its
   plain version and to searchsorted + index_select at the view's two
   shapes (expand_inputs): the pair expansion (100k depth-ranked rows x 16
   onto the view's pair slots) and the tile expansion of aligned segments
   (2,500 tile intervals x 3 onto the same length); each by CUDA events
   and device time, beside both, with its bound and its one launch.
40. kernel H vs plain - forward_fill at 1M x 12 with 100k marks (also
   equal to torch.cummax + a gather) and segmented_fill_rows of 100k rows
   (shared and dropped slots), equal bit for bit (fill_inputs); each by
   CUDA events and device time, with its bound and its one launch.

The evaluation path (the port's CLIs as a user runs them, each in its
own process; kernels A and B, and C, D, E in training):

41. evaluation path - scripts/gen_synthetic_scene_torch.py at 800x800
   (the 60k teacher; 4 train, 2 val and 2 test views): exit 0, the pair
   slots of every view printed, A and B launched once a view;
   train_torch.py apps/nerf_synthetic_3dgut on it for 0 and for 200
   steps: exit 0, A-D launched every step; render_torch.py on both
   ckpt_last.npz: exit 0, metrics.json with every key of render.py's,
   A and B launched once a test view, psnr finite and above the 0-step
   checkpoint's; validate_torch.py --iterations 30: exit 0, three rows,
   the NHT kernels launched; LPIPS with random_params(0) on the card
   against the same call on the CPU (within 1e-4 relative, TF32 off).

The cuSFM path (apps/cusfm_3dgut_mcmc as published: MCMC capacity
2,300,000, SH 3, white background, PPISP with the controller, from a
1,000,000-point fused cloud of the 60k teacher's points on 1920x1080
pinhole views; kernels A-D):

42. ISP, controller and step - the ISP's forward and backward at
   1920x1080 on the card against its float64 version on the CPU
   (forward and the tables' gradients within 1e-5, the image gradient
   within 1e-5 of its largest but on at most ISP_FLIP_CAP elements;
   the CRF's toe and shoulder drawn at 2 or more, isp_inputs), their
   times and kernels; the same at the CRF the trainer starts from and
   at trained values under 2, held no worse than the fp32 chain on the
   CPU (isp_fp32_check); the controller on the distillation's 480x270
   input within 1e-5 of float64; the fused cloud written as a PLY
   (synthetic.write_fused_cloud) and read back by train_torch.py's
   make_model: 1,000,000 Gaussians, capacity 2,300,160; 20 timed steps of
   the Trainer with PPISP on and off: A-D and D's inversion launch 20
   times, E never; ms/step, and 5 traced steps' device busy, idle share
   and device kernels a step.
43. cuSFM CLI - a 12-view 1920x1080 COLMAP capture, each view's colours
   scaled by an exposure offset in [-0.5, 0.5] stops; train_torch.py
   --config-name apps/cusfm_3dgut_mcmc from the fused cloud, 200 steps,
   a 300-step distillation whose loss falls, export_ply: exit 0, A-D
   launched every step (A and B also per distillation render and
   validated view), E never, the learned exposures' correlation with
   the offsets at least CUSFM_EXPOSURE_CORR; 10 steps each from
   initialization.method=checkpoint on its checkpoint and from
   import_ply on its export; apps/colmap_3dgut with gsplat_normalize and
   gsplat_image_downscale at factor 2, 30 steps (the images_2_png cache
   built); render_torch.py on the PPISP checkpoint, A and B once a test
   view.

Then a JSON line with each kernel's launches (A-D from phase 11, sorted
B and C of each setting from phase 17, E from phase 18, the general
kernels from phases 23-24, the NHT kernels from phase 29, kernel 7's B,
C and D from phase 32, W 128 C from phase 33, normals B from phase 34,
W 128 B from the playground frame of phase 36, F from the table route's
3DGUT steps in phase 38, with its set-up's as setup_launches; G's pair
and tile expansions (expand_rows, expand_rows_tiles) and H's
forward_fill and segmented_fill_rows (fill, fill_segmented), each from
its own call in phases 39 and 40; and, as cusfm_launches, the cuSFM
path's kernels' launches by entry point: phase 42's steps with and
without PPISP, phase 43's CLIs),
error and times (phases 3, 4, 8, 9, 13-15, 19-21, 26-27, 31-34, 37, 39,
40; G and H also by device time), its bound (the larger
of the fp32 operations over 67 TFLOP/s and the bytes it must read and
write over 3.35 TB/s, from this run's inputs: for G and H only the rows
that a non-empty interval, a mark or a slot's last row selects, and
segmented_fill_rows' slots; for B, C and E the accept
test on every (pair, pixel) of the tiles and the response of each
candidate the plain forward composited, for NHT also its features at
each such candidate; for B and E in their RGB modes and trace's B and
C, whose cull tests only some pairs, the work this run's rays need: the
cull at staging, the warps' pyramid tests (and trace's rays' sphere
tests), the exact test of what the cull keeps, in the windows each ray
walks before its kill, and the composited candidates' response) and, for
kernels D and F, the time of index_add_,
for G that of searchsorted + index_select, for forward_fill that of
cummax + a gather (none for segmented_fill_rows); for C's NHT mode and
F also the kernels' resources, C's sine
error, F's set-up and kernel times apart; for B and E in their RGB
modes and trace's B and C (kernel 7 and windows of 128) the share of
(pair, pixel) tests their cull removes (culled_share) and, as
bound_all_pairs_ms, the bound of the exact test on every (pair, pixel),
which JAX's function does; B's registers in its RGB modes;
for the kernels phase 41's entry points launch, their launches by entry
point (eval_launches); the card's name and power limit, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX. Needs one card; there is no CPU fallback.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_VIEWS = 8
SIDE = 800
TRAIN_STEPS = 20
REPO = os.path.dirname(os.path.abspath(__file__))
PARAM_NAMES = ("positions", "rotation", "scale", "density",
               "features_albedo", "features_specular")
# kernel libraries built from csrc/
LIBS = ("bin_decode", "raster_fwd", "raster_bwd", "fold", "wmax",
        "scatter_rows", "expand_rows", "fill")
# the card's peaks (NVIDIA's H100 SXM data sheet): fp32 outside the tensor
# cores, and HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one common.cuh hit evaluation. Every evaluation runs
# hit_from_a up to its accept test: b = M d 15, c = a x b 9, m and 1/m 7,
# |c|^2 5, sq 1, the test 1 (38); eval_hit_general first forms e = o - p 3
# and a = M e 15 (56). By general:
TEST_FLOPS = {False: 38, True: 56}
# what an accepted candidate adds: q 5, hit_t 2, its range test 2, the
# response 2 (3 at degree 4), alpha 2, and in the general mode the |d|
# scale 1. By (degree, general):
ACCEPT_FLOPS = {(2, False): 13, (4, False): 14, (2, True): 14, (4, True): 15}
# what NHT adds per composited candidate (common.cuh:nht_hit and kernel
# B's blend loop): tc 1, c = a + b tc 6, the barycentric weights 15, the
# 12 blends 84, 12 sincosf charged 2 operations each (a sine and a
# cosine, the function's own work; the accurate libdevice routine the
# kernel calls spends ~20x that in instructions), and w sin, w cos into
# the 24 accumulators 48
NHT_ACCEPT_FLOPS = 178
# what kernel C's NHT mode does per composited candidate beyond the
# accept (raster_bwd.cu:raster_bwd_nht_kernel): nht_hit again 22, the 12
# blends 84, 12 sincosf 24 (charged as above), u = <g_feat, f> + g_depth
# hit_t 49, w, the residual and g_alpha 12, e_k 48, d bary 96, d c 12,
# tc's cotangent 8, pull_ab 56 (the response's slope charged 3), c's
# cotangent onto a and b 9, general_rows 42, d density 1, the 48 feature
# cotangents bary_v e_k 48, and the sum of the 61 fields over the pixels
# 61
NHT_BWD_ACCEPT_FLOPS = 572
# what kernel C's RGB modes do per composited candidate beyond the accept
# (raster_bwd.cu, counted as NHT_BWD_ACCEPT_FLOPS is): composite's w 1,
# u = <g_feat, rgb> + g_depth hit_t 7, its prefix 2, the residual 1,
# g_alpha 7, T 2 and the kill 1 (21); pullback's g_hit_t 1 (2 in the
# general mode, scaled by |d|); pull_ab 52 (54 at degree 4: the
# response's slope 3, not 1): d_resp 1, the slope 1, d_sq 1, d_q 1,
# d_inv_m 3, d_c2 1, d_m 2, g_c 6, d_a 15, d_b 21; then d_M = d_b d^T 9,
# or general_rows 42 (d_p = -M^T d_a 15, d_M 27); d density 1, d rgb 3;
# and the sum of the 16 fields over the pixels 16. By (degree, general):
BWD_ACCEPT_FLOPS = {(2, False): 103, (4, False): 105, (2, True): 137,
                    (4, True): 139}
# pixels of a 1920x1280 general-mode view whose kernel and plain versions
# kill one candidate apart (phase 19; 1 seen at 3DGRT in 2,457,600)
KILL_FLIP_CAP = 8
# operations of kernel A's conic cull per pair slot
# (ops/ut.py:tile_min_power_response)
CULL_FLOPS = 60
# fp32 operations of trace's cull (common.cuh): stage_cull per staged pair
# (cull_radius: the rows' norms 15, their min and max 4, kappa 2, the
# radius terms 8; a2 and b2 4), bundle_keeps per (pair, warp pyramid)
# (p - c 3, |p - c| 6, the reach 5, five planes 30) and sphere_keeps per
# (pair, pixel) in the warp's list (e 3, e x d 9, |e x d|^2 5, |e|^2 5,
# the test 4)
TRACE_CULL_FLOPS = {"stage": 33, "bundle": 44, "sphere": 26}
# fp32 operations of the cull of B's and E's RGB modes (common.cuh:
# stage_rgb_row), by (general, ellipsoid); no sphere test. The sphere:
# per staged pair cull_radius 29 (trace's stage_cull without a2 and b2),
# and in the shared-origin mode the centre 19 (3 divisions, -M^T u 15,
# b's margin 1) and the reach taken once 9 (|p| 6, a + 2 b |p| 3); per
# (pair, warp pyramid) the five planes 30, or in the general mode
# bundle_keeps 44 as trace's. The ellipsoid (degree 2 in global-Z order)
# adds per staged pair cull_quadric 65 (kappa^2 1, the weights 6, g 3,
# the six entries 54, a^2 1) less the sphere's reach 1 (shared: 9 - 1 +
# 65 + 2 b |p| 2 = 121 in all; general 29 + 65 = 94), and per pyramid the
# apex plane 7 and four side planes of 21 (dot 5, n^T Q n 11, the least
# 1, d 1, d^2 1, two tests 2): 91, and in the general mode p - c 3, |p -
# c| 6 and the slack 4 more (104)
RGB_CULL_FLOPS = {
    (False, False): {"stage": 57, "bundle": 30, "sphere": 0},
    (True, False): {"stage": 29, "bundle": 44, "sphere": 0},
    (False, True): {"stage": 121, "bundle": 91, "sphere": 0},
    (True, True): {"stage": 94, "bundle": 104, "sphere": 0}}
# reported kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "bin_decode": ("threedgrut_tpu_torch/csrc/bin_decode.cu",
                   "threedgrut_tpu/ops/pallas/expand.py:86"),
    "raster_fwd": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                   "threedgrut_tpu/ops/pallas/raster.py:1147"),
    "raster_bwd": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                   "threedgrut_tpu/ops/pallas/raster.py:1981"),
    "fold": ("threedgrut_tpu_torch/csrc/fold.cu",
             "threedgrut_tpu/ops/pallas/fold.py:76"),
    # kernel B in the sorted mode, 3DGRT (W = 16, degree 4):
    # bitonic_sort_by_key and bitonic_replay_unsort in the forward strip
    # kernel
    "raster_fwd_sorted": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                          "threedgrut_tpu/ops/pallas/raster.py:686"),
    # kernel C in the sorted mode, 3DGRT: _bwd_chunk_fast_sorted
    "raster_bwd_sorted": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                          "threedgrut_tpu/ops/pallas/raster.py:1814"),
    # the same in the sorted 3DGUT setting (W = 16, degree 2)
    "raster_fwd_sorted_3dgut": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                                "threedgrut_tpu/ops/pallas/raster.py:686"),
    "raster_bwd_sorted_3dgut": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                                "threedgrut_tpu/ops/pallas/raster.py:1814"),
    "wmax": ("threedgrut_tpu_torch/csrc/wmax.cu",
             "threedgrut_tpu/ops/pallas/raster.py:2199"),
    # the general-geometry mode (kernel 5): chunk_hits_general and the
    # general pullback of _bwd_chunk_grads, in kernels B, C and E; 3DGUT
    # (degree 2, W 0) and, with the _grt suffix, 3DGRT (degree 4, W 16)
    "raster_fwd_general": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                           "threedgrut_tpu/ops/pallas/raster.py:378"),
    "raster_bwd_general": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                           "threedgrut_tpu/ops/pallas/raster.py:1899"),
    "raster_fwd_general_grt": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                               "threedgrut_tpu/ops/pallas/raster.py:378"),
    "raster_bwd_general_grt": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                               "threedgrut_tpu/ops/pallas/raster.py:1899"),
    "wmax_general": ("threedgrut_tpu_torch/csrc/wmax.cu",
                     "threedgrut_tpu/ops/pallas/raster.py:378"),
    # the NHT mode (kernel 8): tetra_barycentric :593 and
    # nht_feature_weighted_sum :609 in the forward strip kernel,
    # nht_hit_features :634 in the backward; 3DGUT (degree 2) and, with
    # the _grt suffix, 3DGRT (degree 4); kernel D folding its 64-wide rows
    "raster_fwd_nht": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                       "threedgrut_tpu/ops/pallas/raster.py:609"),
    "raster_bwd_nht": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                       "threedgrut_tpu/ops/pallas/raster.py:634"),
    "raster_fwd_nht_grt": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                           "threedgrut_tpu/ops/pallas/raster.py:609"),
    "raster_bwd_nht_grt": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                           "threedgrut_tpu/ops/pallas/raster.py:634"),
    "fold_64": ("threedgrut_tpu_torch/csrc/fold.cu",
                "threedgrut_tpu/ops/pallas/fold.py:76"),
    # trace(): the shared-segment mode (kernel 7) of B and C, shared_segments
    # in the forward and backward strip kernels, with D folding its rows
    # per block; windows of 128 (the sorted mode at sort_window = CHUNK)
    # in the grid's per-block segments; the normals mode of B
    # (compute_normals)
    "raster_fwd_shared_segment": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                                  "threedgrut_tpu/ops/pallas/raster.py:1158"),
    "raster_bwd_shared_segment": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                                  "threedgrut_tpu/ops/pallas/raster.py:2051"),
    "fold_shared_segment": ("threedgrut_tpu_torch/csrc/fold.cu",
                            "threedgrut_tpu/ops/pallas/fold.py:76"),
    # kernel D on the grid trace's rows (pairs naming particles directly,
    # the inverse from the caller's sort): fold_sorted_intervals's
    # _fold_kernel, the narrow fold the JAX grid backward reaches
    "fold_grid": ("threedgrut_tpu_torch/csrc/fold.cu",
                  "threedgrut_tpu/ops/pallas/fold.py:38"),
    # the inverse of the tile sort, which D's wrapper takes from D's own
    # library where the caller has none (render/gut.py:_grf_bwd's
    # un-permute, fused into the TPU's fold)
    "fold_invert": ("threedgrut_tpu_torch/csrc/fold.cu",
                    "threedgrut_tpu/ops/pallas/fold.py:76"),
    "raster_fwd_window128": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                             "threedgrut_tpu/ops/pallas/raster.py:885"),
    "raster_bwd_window128": ("threedgrut_tpu_torch/csrc/raster_bwd.cu",
                             "threedgrut_tpu/ops/pallas/raster.py:1899"),
    "raster_fwd_normals": ("threedgrut_tpu_torch/csrc/raster_fwd.cu",
                           "threedgrut_tpu/ops/pallas/raster.py:1238"),
    # the row scatter of the table route's backward
    # (raster.py:rasterize_tiles_table, whose B and C are raster_fwd and
    # raster_bwd; they also serve the flat-grid kernels raster.py:1336 and
    # :1382, the same function on another schedule)
    "scatter_rows": ("threedgrut_tpu_torch/csrc/scatter_rows.cu",
                     "threedgrut_tpu/ops/pallas/scatter.py:29"),
    # the interval expansion and the segmented fill, standalone ops
    # (G: the pair and the tile expansion; H: forward_fill and
    # segmented_fill_rows)
    "expand_rows": ("threedgrut_tpu_torch/csrc/expand_rows.cu",
                    "threedgrut_tpu/ops/pallas/expand.py:45"),
    "expand_rows_tiles": ("threedgrut_tpu_torch/csrc/expand_rows.cu",
                          "threedgrut_tpu/ops/pallas/expand.py:45"),
    "fill": ("threedgrut_tpu_torch/csrc/fill.cu",
             "threedgrut_tpu/ops/pallas/fill.py:31"),
    "fill_segmented": ("threedgrut_tpu_torch/csrc/fill.cu",
                       "threedgrut_tpu/ops/pallas/fill.py:31"),
}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time of the card for this work,
    the larger of its bytes over the memory rate and its fp32 operations
    over the fp32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def raster_bound(args, outputs, rc, general, accepted, extra_flops=0,
                 shared_tiles=0):
    """The bound of kernel B, C or E on ``args`` (the wrapper's tensors),
    writing ``outputs``: every pair of the tiles tested on the tile's 256
    pixels, and the ``accepted`` candidates (the plain forward's hit
    count summed over the view: those it composited) carried through
    the response and ``extra_flops`` more (NHT_ACCEPT_FLOPS for NHT B's
    features at the hit; kernel C's pullback: BWD_ACCEPT_FLOPS, or
    NHT_BWD_ACCEPT_FLOPS in the NHT mode).
    Candidates that pass the test but miss the ray's range are charged the
    test only. ``shared_tiles``: the tiles that each walk the one shared
    segment of ``args[2]`` (kernel 7). Kernels whose cull leaves pairs
    untested (B and E in their RGB modes, trace's B and C) take
    cull_bound, with this beside it (cull_bound_keys)."""
    pairs = int(args[2][-1])
    if shared_tiles:
        pairs = int(args[2][1] - args[2][0]) * shared_tiles
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    per_accept = ACCEPT_FLOPS[(rc.kernel_degree, general)] + extra_flops
    return bound(nbytes(*tensors, *outputs),
                 pairs * 256 * TEST_FLOPS[general] + accepted * per_accept)


def cull_bound(args, outputs, rc, cull, accepted, general, flops):
    """The bound of a kernel whose cull leaves pairs untested, on ``args``
    writing ``outputs``, from the work this run's rays need (``cull``:
    ops/cuda/raster.py:cull_plain's counts, over the windows each ray
    walks before its kill): the cull staged once per (pair, block that
    walks it), each warp pyramid's test of it, the sphere test of each
    (pair, pixel) in the warp's list (trace only), the exact test of each
    the cull keeps, and the ``accepted`` candidates (the plain forward's
    composited count) carried through the response; ``flops``:
    TRACE_CULL_FLOPS, or RGB_CULL_FLOPS of the mode. Each k-buffer pass
    past the first (trace), and the tests of a killed ray's last window
    after its kill, are not charged."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ops = (cull["staged"] * flops["stage"]
           + cull["bundle_tests"] * flops["bundle"]
           + cull["sphere_tests"] * flops["sphere"]
           + cull["exact_tests"] * TEST_FLOPS[general]
           + accepted * ACCEPT_FLOPS[(rc.kernel_degree, general)])
    return bound(nbytes(*tensors, *outputs), ops)


def cull_bound_keys(args, outputs, rc, cull, accepted, general=True,
                    flops=TRACE_CULL_FLOPS, shared_tiles=0):
    """bound_keys of cull_bound (trace's B or C by default), with the
    bound of the exact test on every (pair, pixel) (raster_bound) beside
    it as bound_all_pairs_ms."""
    return dict(bound_all_pairs_ms=raster_bound(
        args, outputs, rc, general, accepted, shared_tiles=shared_tiles)[0],
        **bound_keys(cull_bound(args, outputs, rc, cull, accepted, general,
                                flops)))


def rgb_bound_keys(args, outputs, rc, cull, accepted):
    """cull_bound_keys of kernel B or E in an RGB mode with a cull (``args``
    with a ray_o: the general mode; the ellipsoid at degree 2 in global-Z
    order, else the sphere). B at degree 4 in global-Z order walks every
    pair: raster_bound is its bound."""
    general = len(args) > 7 and args[7] is not None
    ellipsoid = not rc.sorted_compositing and rc.kernel_degree == 2
    return cull_bound_keys(args, outputs, rc, cull, accepted, general,
                           RGB_CULL_FLOPS[(general, ellipsoid)])


def composited(fwd):
    """The candidates a forward output (features, opacity, depth, hits,
    T_final) composited: its hit counts summed."""
    return float(fwd[3].double().sum())


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def resources(res):
    """A kernel's resources (build.attributes) in a phase line."""
    return (f"{res['registers']} registers, {res['local_bytes']} local "
            f"bytes, {res['shared_bytes']} static + "
            f"{res['dynamic_shared_bytes']} dynamic shared bytes")


def bound_keys(b, library_ms=None):
    """The report keys of a kernel's bound (and its library yardstick)."""
    return dict(bound_ms=b[0], bound_by=b[1], library_ms=library_ms)


def index_add_ms(d_args):
    """Kernel D's yardstick: the time of the one PyTorch call that sums
    each particle's pair rows, torch.zeros(N, R).index_add_(0,
    particle_of_pair, d_records), on the fold's own inputs (fold_pairs's
    arguments, through perm or the inverse; timed only; the port never
    calls it)."""
    d_rec, perm, order, _, counts, limit, capacity = d_args[:7]
    inv = d_args[7] if len(d_args) > 7 else None
    owner = torch.repeat_interleave(
        torch.arange(order.shape[0], device=d_rec.device),
        counts.to(torch.int64))[:limit]
    if inv is not None:
        particle = order.to(torch.int64)[owner]
        rows = d_rec[inv[:owner.shape[0]].to(torch.int64)]
    else:
        slot = perm.to(torch.int64)
        keep = slot < owner.shape[0]    # slots no rank owns (trace's dead row)
        particle = order.to(torch.int64)[owner][slot[keep]]
        rows = d_rec[keep]
    return cuda_ms(lambda: torch.zeros(
        (capacity, d_rec.shape[1]), dtype=torch.float32,
        device=d_rec.device).index_add_(0, particle, rows), 20)


def fold_check(fn, plain, label, reps=20):
    """Kernel D's wrapper call fn() against its float64 plain version
    plain(): within 1e-5 of max |ref| and two runs bitwise equal, else
    raise. Returns (report keys: max_abs_err, ms by events, device_ms,
    plain_ms; max |ref|; the output)."""
    f1, f2 = fn(), fn()
    ref, plain_ms = timed_once(plain)
    err = float((f1 - ref).abs().max())
    scale = float(ref.abs().max())
    same = bool(torch.equal(f1, f2))
    if not (err <= 1e-5 * scale and same):
        raise AssertionError(f"kernel D ({label}) vs plain: max |d| "
                             f"{err:.3g} (max |ref| {scale:.3g}); bitwise "
                             f"repeatable {same}")
    return (dict(max_abs_err=err, ms=cuda_ms(fn, reps),
                 device_ms=device_ms(fn, reps), plain_ms=plain_ms),
            scale, f1)


def fold_bound(d_rec, rows_read, index_tensors, out):
    """Kernel D's bound: the ``rows_read`` gradient rows its data needs
    (those some rank owns and, with n_valid, before the culled ones), its
    index inputs and the output, each once; one fp32 add per element
    read."""
    row_bytes = rows_read * d_rec.shape[1] * d_rec.element_size()
    return bound(row_bytes + nbytes(*index_tensors, out),
                 rows_read * d_rec.shape[1])


def fold_msg(keys, scale, lib_ms):
    return (f"max |d| {keys['max_abs_err']:.3g} of {scale:.3g}, two runs "
            f"bitwise equal, {keys['ms']:.4f} ms (device "
            f"{keys['device_ms']:.4f}), plain {keys['plain_ms']:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms")


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def timed_once(fn):
    """(fn(), its device time in ms): one call between CUDA events, for
    the float64 plain versions, whose one call is the reference."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def host_ms(fn, reps):
    """Mean host-clock ms of fn() over reps calls after one warm-up, the
    device synchronised at both ends (for work that reads back from the
    device on its way, as trace's grid does)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_calls(fn, reps):
    """[({kernel name: records}, {kernel name: device us}) of one call of
    fn(), the same of reps calls], from one torch.profiler session. The
    profiler drops the records of a session's first milliseconds (on the
    H100: up to the first 69 kernels, and a whole kernel's records of a
    short window): the session opens with reps pad calls and a 20 ms
    wait, and a kernel is
    counted in the span between marks set on the host's clock (which the
    profiler's device times share) in which it starts; each span begins a
    millisecond after the work before it has ended."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def mark(name):
        torch.cuda.synchronize()
        time.sleep(1e-3)
        with record_function(name):
            pass
        time.sleep(1e-3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
        mark("device_ms_one")
        fn()
        mark("device_ms_reps")
        for _ in range(reps):
            fn()
        mark("device_ms_end")
    events = prof.events()
    marks = {e.name: e.time_range.start for e in events
             if e.name.startswith("device_ms_")}
    spans = [(marks["device_ms_one"], marks["device_ms_reps"]),
             (marks["device_ms_reps"], marks["device_ms_end"])]
    out = [({}, {}), ({}, {})]
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("device_ms_")):
            continue
        for k, (t0, t1) in enumerate(spans):
            if t0 <= e.time_range.start < t1:
                counts, us = out[k]
                counts[e.name] = counts.get(e.name, 0) + 1
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


# profiler sessions device_ms takes before it gives up
DEVICE_MS_WINDOWS = 5


def device_ms(fn, reps, by_kernel=False):
    """Device time per call of fn(): the device time of the kernels it
    launches over reps calls (torch.profiler), after one warm-up; unlike
    cuda_ms it leaves out the host's enqueueing. The kernels of one call,
    by name and launches, are read first; the reps calls count only if
    they hold each of them exactly reps times that and no other, else
    both are taken again, up to DEVICE_MS_WINDOWS times, and then it
    raises (a reading short of a kernel's records is never returned).
    With ``by_kernel``: (that time, {kernel name: its ms per call})."""
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_WINDOWS):
        (one, _), (counts, us) = _profiled_calls(fn, reps)
        if one and counts == {k: c * reps for k, c in one.items()}:
            per = {k: u / reps / 1e3 for k, u in us.items()}
            total = sum(per.values())
            return (total, per) if by_kernel else total
        print(f"device_ms: windows disagree: one call {one}, {reps} calls "
              f"{counts}", flush=True)
    raise RuntimeError(f"device_ms: no window of {reps} calls held every "
                       f"kernel of one call in {DEVICE_MS_WINDOWS} tries")


def seeded_upstream(dev, h, w, channels, seed):
    """Seeded standard-normal upstream gradients [h, w, c], one for each c
    of channels (phase 8: (3, 1, 1) from seed 7; phase 27: (24, 1, 1) from
    seed 26)."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(h, w, c)).astype(np.float32),
                         device=dev) for c in channels]


def view_inputs(cam, ut_cfg, rc, model, sh_degree, upstream):
    """(view, B's arguments, B's outputs, C's arguments) of one view, as
    phases 3, 4 and 8 (and, for NHT, 26 and 27) take them: B on the view's
    pairs, C on B's outputs and the given upstream gradients."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_forward
    from threedgrut_tpu_torch.render.gut import prepare_view

    with torch.no_grad():
        v = prepare_view(cam, ut_cfg, rc, model, sh_degree)
        b_args = (v.table, v.binning.pair_particle, v.binning.tile_start,
                  v.ray_d, v.tmin, v.tmax, rc)
        if v.ray_o is not None:
            b_args += (v.ray_o,)
        fwd = rasterize_tiles_forward(*b_args)
    c_args = b_args[:6] + (fwd[0], fwd[2], fwd[4], *upstream) + b_args[6:]
    return v, b_args, fwd, c_args


def fixture_model(f, dev):
    """The model of a JAX parity fixture (tests/fixtures)."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)

    cfg = GaussianModelConfig(
        density_activation=str(f["density_activation"]),
        scale_activation=str(f["scale_activation"]),
        max_sh_degree=int(f["n_active_features"]))
    return GaussianModel.from_numpy(
        {k: f[f"params/{k}"] for k in PARAM_NAMES},
        int(f["n_active"]), int(f["n_active_features"]), cfg, dev)


def fixture_scene(f, dev):
    """(model, camera) of a JAX parity fixture (tests/fixtures)."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole

    model = fixture_model(f, dev)
    cam = make_pinhole(tuple(int(x) for x in f["resolution"]), f["focal"],
                       f["principal"], t=f["t"], q=f["q"], device=dev)
    return model, cam


def fixture_loss(out):
    """The loss of tests/test_render_parity.py:49-61 (zero target)."""
    return (out["pred_features"].square().mean()
            + 0.1 * out["pred_opacity"].mean()
            + 0.01 * out["pred_dist"].mean())


def trainer_phase(dev, raster=None, prune_weight=False, camera="pinhole"):
    """Phases 12, 18 and 24: a Trainer from 100k random Gaussians on 8
    teacher views (white background) at 800x800, or through the
    rolling shutter of synthetic.py:CAMERA_KINDS at 1920x1280, 260 steps
    with the GS events moved early: densify and prune at steps 100 and
    200, a density reset at 250; with ``prune_weight``, blend-weight
    telemetry every 10 steps after step 100 and a weight prune at 150.
    ``raster`` is the student's RasterConfig (default: 3DGUT). Returns
    the launches of kernel E (in the general mode for the rolling
    shutter)."""
    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max
    from threedgrut_tpu_torch.models.gaussians import (
        GaussianModelConfig, default_capacity_for, random_initialization)
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset
    from threedgrut_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    ds = teacher_dataset(build_teacher(60000, seed=0, device=dev),
                         n_views=8, side=SIDE, camera=camera)
    extent = ds.get_scene_extent()

    def fresh_model():
        return random_initialization(
            GaussianModelConfig(), 100_000, extent=extent, seed=42,
            capacity=default_capacity_for(100_000, headroom=4.0),
            device=dev)

    conf = TrainerConfig(background=BackgroundConfig(color="white"))
    if raster is not None:
        conf.raster = raster
    conf.gs = conf.gs.replace(
        densify_start=50, densify_frequency=100, densify_end=210,
        prune_start=50, prune_frequency=100, prune_end=210,
        reset_density_start=240, reset_density_frequency=250,
        reset_density_end=260)
    if prune_weight:
        conf.gs = conf.gs.replace(
            prune_weight_start=100, prune_weight_frequency=50,
            prune_weight_end=160, weight_telemetry_frequency=10,
            prune_weight_threshold=0.01)
    trainer = Trainer(conf, ds, fresh_model())
    pair_weight_max.launches = pair_weight_max.launches_general = 0
    n0 = trainer.model.n_active
    hist = trainer.run_training(250)
    dens = trainer.model.get_density()[:trainer.model.n_active]
    reset_ok = bool((dens <= conf.gs.new_max_density).all())
    hist += trainer.run_training(260)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    e_launches = (pair_weight_max.launches_general if camera == "rolling"
                  else pair_weight_max.launches)
    events = trainer.event_stats
    densified = [st for _, kind, st in events if kind == "densify"]
    grown = sum(st["n_cloned"] + st["n_split"] for st in densified)
    counts = [n0] + [st["n"] for _, _, st in events]
    early = float(np.mean([h["psnr"] for h in hist[0:20]]))
    late = float(np.mean([h["psnr"] for h in hist[229:249]]))
    ckpt = os.path.join(REPO, "build", "smoke_trainer_ckpt.npz")
    trainer.save_checkpoint(ckpt)
    frame = ds[0]
    loss_a = trainer.train_iteration(frame, frame_idx=0)["total"]
    again = Trainer(conf, ds, fresh_model())
    again.load_checkpoint(ckpt)
    loss_b = again.train_iteration(frame, frame_idx=0)["total"]
    os.remove(ckpt)
    checks = {
        "densify grew": len(densified) == 2 and grown > 0,
        "n_active changed": len(set(counts)) > 1,
        "psnr +2 dB": late >= early + 2.0,
        "reset clamps density": reset_ok,
        "checkpoint round trip": abs(loss_a - loss_b) <= 1e-6,
        "finite": all(np.isfinite(h["total"]) for h in hist),
    }
    if prune_weight:
        wpruned = [st for _, kind, st in events if kind == "weight-pruned"]
        checks["weight prune dropped particles"] = (
            len(wpruned) == 1 and wpruned[0]["n_pruned"] > 0)
        checks["kernel E launched"] = e_launches > 0
    w, h = ds[0].resolution
    summary = (f"{w}x{h}, {len(hist)} steps in {train_s:.1f} s; kernel E "
               f"launches "
               f"{e_launches}; events "
               + "; ".join(f"[{s_}] {k} " + " ".join(
                   f"{a}={b}" for a, b in st.items())
                   for s_, k, st in events)
               + f"; psnr steps 1-20 {early:.2f} dB, 230-249 {late:.2f} dB;"
               f" resumed loss |d| {abs(loss_a - loss_b):.3g}")
    failed = [k for k, ok in checks.items() if not ok]
    name = ("rolling trainer" if camera == "rolling" else
            "3DGRT trainer" if prune_weight else "trainer")
    if failed:
        raise AssertionError(f"{name}: {failed} ({summary})")
    phase(name, summary)
    return e_launches


def grad_agreement(got, ref, first="a"):
    """(cosine, relative L2) per record field group of per-pair
    gradients; ``first`` names rows 0-2 (a, or the general mode's p)."""
    stats = {}
    for nm, sl in ((first, slice(0, 3)), ("M", slice(3, 12)),
                   ("density", slice(12, 13)), ("rgb", slice(13, 16))):
        x = got[:, sl].double().flatten()
        y = ref[:, sl].double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
        rel = float((x - y).norm() / y.norm().clamp(min=1e-300))
        stats[nm] = (cos, rel)
    return stats


GRT_GRAD_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                "torch_port_grt_grad_small.npz")
# label -> (fixture mode, report-name suffix) of the two sorted settings
SORTED = {"3DGRT": ("grt", ""), "sorted 3DGUT": ("sorted3dgut", "_3dgut")}


def sorted_settings():
    """{label: RasterConfig} of the two sorted settings, as the gradient
    fixture records them (tests/test_torch_grt.py holds them to
    train_torch.py's composition of the two configs)."""
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config

    with np.load(GRT_GRAD_FIXTURE) as f:
        out = {label: RasterConfig(**{
            k: f[f"{mode}/raster/{k}"].item() for k in (
                "kernel_degree", "min_transmittance", "sorted_compositing",
                "sort_window")}) for label, (mode, _) in SORTED.items()}
    if out["3DGRT"] != grt_raster_config():
        raise AssertionError(f"fixture's 3DGRT settings {out['3DGRT']} are "
                             "not grt_raster_config()")
    return out


def sorted_kernel_phases(dev, b_args, fwd, c_args, v, model, ut_cfg):
    """Phases 13-15: kernels B and C in the sorted mode and kernel E
    against their plain versions on the phase-3 view, and 3DGRT serving.
    Returns the report entries of the sorted kernels B and C of each
    setting and of wmax."""
    from threedgrut_tpu_torch.ops.cameras import orbit_camera
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_backward_plain,
        rasterize_tiles_forward, rasterize_tiles_plain, rgb_kernel_attributes)
    from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                    pair_weight_max_plain)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import orbit_geometry

    settings = sorted_settings()
    report, accepted, culls = {}, {}, {}
    # 13. sorted kernel B
    msgs = []
    for label, rc in settings.items():
        args = b_args[:6] + (rc,)
        with torch.no_grad():
            got = rasterize_tiles_forward(*args)
            ref = rasterize_tiles_plain(*args)
            torch.cuda.synchronize()
            err_f = float((got[0] - ref[0]).abs().max())
            err_o = float((got[1] - ref[1]).abs().max())
            err_t = float((got[4] - ref[4]).abs().max())
            err_d = float(((got[2] - ref[2]).abs()
                           / ref[2].abs().clamp(min=1e-3)).max())
            flips = float((got[3] != ref[3]).float().mean())
            # how far the windows move the image from global-Z order
            moved = float((got[0] - rasterize_tiles_forward(
                *b_args[:6], rc.replace(sorted_compositing=False))[0]
                           ).abs().max())
            ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 20)
            plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*args), 2)
            share, culls[label], cull_msg = cull_check(
                args, f"sorted kernel B ({label})")
        if not (err_f <= 1e-4 and err_o <= 1e-4 and err_t <= 1e-4
                and err_d <= 1e-3 and flips < 0.01):
            raise AssertionError(
                f"sorted kernel B ({label}) vs plain: features {err_f:.3g},"
                f" opacity {err_o:.3g}, T_final {err_t:.3g}, depth rel "
                f"{err_d:.3g}, hits flip {flips:.4f}")
        accepted[label] = composited(ref)
        res = rgb_kernel_attributes("raster_fwd")[
            f"rgb_{rc.kernel_degree}_w16"]
        report["raster_fwd_sorted" + SORTED[label][1]] = dict(
            max_abs_err=max(err_f, err_o, err_t), ms=ms, plain_ms=plain_ms,
            culled_share=share, resources=res,
            **rgb_bound_keys(args, got, rc, culls[label], accepted[label]))
        msgs.append(f"{label} (degree {rc.kernel_degree}, W "
                    f"{rc.sort_window}): features |d| {err_f:.3g}, opacity |d| "
                    f"{err_o:.3g}, T_final |d| {err_t:.3g}, depth rel "
                    f"{err_d:.3g}, hits flip {flips:.5f} (sorted vs "
                    f"global-Z features |d| {moved:.3g}); kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms; {cull_msg}; "
                    f"{resources(res)}")
    phase("sorted kernel B", "; ".join(msgs))

    # 3DGRT serving: 8 orbit views through make_serving_renderer
    center, dist = orbit_geometry(model)
    cams = [orbit_camera(az, 0.35, dist, center=center,
                         resolution=(SIDE, SIDE), device=dev)
            for az in np.linspace(0.0, 2 * math.pi, N_VIEWS, endpoint=False)]
    serve = make_serving_renderer(model, grt_raster_config(), sh_degree=3,
                                  ut_cfg=ut_cfg)
    serve(cams)
    per_batch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = serve(cams)
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3 / N_VIEWS)
    if not bool(torch.isfinite(imgs).all()):
        raise AssertionError("3DGRT serving output has non-finite values")
    phase("3DGRT serving", f"{N_VIEWS} views {SIDE}x{SIDE}, 100k, SH 3: "
          f"median {float(np.median(per_batch)):.3f} ms/frame host clock "
          f"over 3 batches ({', '.join(f'{x:.3f}' for x in per_batch)})")

    # 14. sorted kernel C, and bitwise repeatability
    msgs = []
    for label, rc in settings.items():
        with torch.no_grad():
            sfwd = rasterize_tiles_forward(*b_args[:6], rc)
            args = c_args[:6] + (sfwd[0], sfwd[2], sfwd[4]) + c_args[9:12] \
                + (rc,)
            d1 = rasterize_tiles_backward(*args)
            d2 = rasterize_tiles_backward(*args)
            d_ref = rasterize_tiles_backward_plain(*args)
            torch.cuda.synchronize()
            stats = grad_agreement(d1, d_ref)
            same = bool(torch.equal(d1, d2))
            err = float((d1 - d_ref).abs().max())
            ms = cuda_ms(lambda: rasterize_tiles_backward(*args), 10)
            plain_ms = cuda_ms(lambda: rasterize_tiles_backward_plain(*args),
                               1)
        bad = {k: x for k, x in stats.items()
               if not (x[0] >= 0.9999 and x[1] <= 1e-3)}
        if bad or not same:
            raise AssertionError(f"sorted kernel C ({label}) vs plain "
                                 f"(cosine, rel L2): {bad}; bitwise "
                                 f"repeatable {same}")
        res = rgb_kernel_attributes()[f"rgb_{rc.kernel_degree}_w16"]
        report["raster_bwd_sorted" + SORTED[label][1]] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, resources=res,
            **bound_keys(raster_bound(
                args, [d1], rc, False, accepted[label],
                BWD_ACCEPT_FLOPS[(rc.kernel_degree, False)])))
        msgs.append(f"{label}: " + ", ".join(
            f"{k} cos {x[0]:.8f} relL2 {x[1]:.3g}" for k, x in stats.items())
            + f"; max |d| {err:.3g}; two runs bitwise equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {resources(res)}")
    phase("sorted kernel C", "; ".join(msgs))

    # 15. kernel E (its cull is B's: held again on each setting's inputs)
    msgs = []
    for label, rc in (("global-Z", RasterConfig()), *settings.items()):
        args = b_args[:6] + (rc,)
        with torch.no_grad():
            w1 = pair_weight_max(*args)
            w2 = pair_weight_max(*args)
            w_ref = pair_weight_max_plain(*args)
            torch.cuda.synchronize()
            err = float((w1 - w_ref).abs().max())
            same = bool(torch.equal(w1, w2))
            live = float((w1 > 0).float().mean())
            ms = cuda_ms(lambda: pair_weight_max(*args), 20)
            plain_ms = cuda_ms(lambda: pair_weight_max_plain(*args), 2)
            share, cull, cull_msg = cull_check(args, f"kernel E ({label})")
        if not (err <= 1e-6 and same):
            raise AssertionError(f"kernel E ({label}) vs plain: max |d| "
                                 f"{err:.3g}; bitwise repeatable {same}")
        if label == "3DGRT":
            report["wmax"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                culled_share=share,
                **rgb_bound_keys(args, [w1], rc, cull, accepted[label]))
        msgs.append(f"{label}: max |d| {err:.3g}, two runs bitwise equal, "
                    f"{live:.3f} of the pairs weighted; kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms; {cull_msg}")
    phase("kernel E", "; ".join(msgs))
    return report


def grt_grad_phase(dev, ut_cfg):
    """Phase 16: the sorted render's gradients against the JAX fixture."""
    from threedgrut_tpu_torch.render.gut import render_gut

    fx = GRT_GRAD_FIXTURE
    msgs = []
    with np.load(fx) as f:
        for label, rc in sorted_settings().items():
            mode = SORTED[label][0]
            gmodel, gcam = fixture_scene(f, dev)
            out = render_gut(gcam, ut_cfg, rc, gmodel, int(f["sh_degree"]))
            fixture_loss(out).backward()
            errs = {}
            for k in PARAM_NAMES:
                got_g = getattr(gmodel, k).grad.double().cpu().numpy()
                ref_g = f[f"{mode}/grad/{k}"].astype(np.float64)
                scale = np.abs(ref_g).max() + 1e-12
                cos = float((got_g * ref_g).sum() / max(
                    np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
                errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
            bad = {k: x for k, x in errs.items()
                   if not (x[0] <= 2e-3 and x[1] >= 0.9999)}
            if bad:
                raise AssertionError(f"sorted gradients vs JAX ({mode}; "
                                     f"max-normalised error, cosine): {bad}")
            msgs.append(f"{mode} (W {rc.sort_window}, degree "
                        f"{rc.kernel_degree}): " + ", ".join(
                            f"{k} {x[0]:.2g}/{x[1]:.7f}"
                            for k, x in errs.items()))
    phase("sorted grad vs JAX", f"fixture {os.path.basename(fx)}: "
          + "; ".join(msgs))


def sorted_train_step_phase(dev, label, rc):
    """Phase 17: the bench train step with one sorted setting. Returns the
    sorted kernels' launches under their report names."""
    from bench_train_torch import BenchStep, profile_steps, time_steps
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max

    suffix = SORTED[label][1]
    step = BenchStep(dev, rc)
    time_steps(step, 3)                       # warm-up
    counters = {"bin_decode": expand_decode_pairs,
                "raster_fwd_sorted" + suffix: rasterize_tiles,
                "raster_bwd_sorted" + suffix: rasterize_tiles_backward,
                "fold": fold_pairs, "wmax": pair_weight_max}
    for fn in counters.values():
        fn.launches = 0
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    launches = {k: fn.launches for k, fn in counters.items()}
    want = dict.fromkeys(counters, TRAIN_STEPS)
    want["wmax"] = 0
    if launches != want:
        raise AssertionError(f"{label} train-step launches {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError(f"{label} train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"{label} train-step gradient of {k} is "
                                 "not finite and non-zero")
    wall_us, busy_us, n_device = profile_steps(step, 5, top=12)
    phase(f"{label} train step", f"100k Gaussians, {SIDE}x{SIDE}, SH 3, "
          f"L1+DSSIM, Adam, degree {rc.kernel_degree}, W {rc.sort_window}: "
          f"{step_ms:.3f} ms/step ({1e3 / step_ms:.2f} it/s) host clock over "
          f"{TRAIN_STEPS} steps; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; launches {launches}; 5 traced steps: "
          f"wall {wall_us:.1f} us/step, device busy {busy_us:.1f} us/step, "
          f"idle share {1.0 - busy_us / wall_us:.3f}, {n_device:.1f} device "
          f"kernels per step")
    return {k: launches[k] for k in counters if k.startswith("raster")}


SHUTTER_GRAD_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                    "torch_port_shutter_grad_small.npz")
# label -> (report-name suffix, RasterConfig factory) of the general mode's
# two settings: 3DGUT (degree 2, W 0) and 3DGRT (degree 4, W 16)
GENERAL = {"3DGUT": "", "3DGRT": "_grt"}


def general_settings():
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config

    return {"3DGUT": RasterConfig(), "3DGRT": grt_raster_config()}


def general_kernel_phases(dev, model, ut_cfg):
    """Phases 19-21: kernels B, C and E in the general-geometry mode on
    the rolling-shutter bench view, against their plain versions; B also
    against shared-origin B with the table built at the rays' common
    origin; kernel D on C's output beside index_add_. Returns the report
    entries."""
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs, fold_pairs_plain
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles_backward, rasterize_tiles_backward_plain,
        rasterize_tiles_forward, rasterize_tiles_plain, rgb_kernel_attributes)
    from threedgrut_tpu_torch.ops.cuda.wmax import (pair_weight_max,
                                                    pair_weight_max_plain)
    from threedgrut_tpu_torch.render.gut import prepare_view
    from threedgrut_tpu_torch.synthetic import bench_camera

    cam = bench_camera("rolling", device=dev)
    w, h = cam.resolution
    rng = np.random.default_rng(8)
    upstream = [torch.tensor(rng.normal(size=(h, w, c)).astype(np.float32),
                             device=dev) for c in (3, 1, 1)]
    report, msg_b, msg_c, msg_e = {}, [], [], []
    for label, rc in general_settings().items():
        suffix = GENERAL[label]
        with torch.no_grad():
            v = prepare_view(cam, ut_cfg, rc, model, 3)
            if v.ray_o is None:
                raise AssertionError("a rolling shutter took the "
                                     "shared-origin mode")
            vb = v.binning
            args = (v.table, vb.pair_particle, vb.tile_start, v.ray_d,
                    v.tmin, v.tmax, rc, v.ray_o)
            # 19. general B
            got = rasterize_tiles_forward(*args)
            ref = rasterize_tiles_plain(*args)
            torch.cuda.synchronize()
            # kill flips: a pixel whose T lands within rounding of
            # min_transmittance stops one candidate earlier or later in
            # one version (the kernel's fp32 product, the plain version's
            # float64 log-space sum); the one extra contribution is at
            # most max_alpha * min_transmittance and both T_final lie
            # under the threshold. Counted (at most KILL_FLIP_CAP),
            # phase 4's 1e-4 holding on every other pixel.
            pix = torch.maximum(torch.maximum(
                (got[0] - ref[0]).abs().amax(-1),
                (got[1] - ref[1]).abs()[..., 0]),
                (got[4] - ref[4]).abs()[..., 0])
            kill = pix > 1e-4
            n_kill = int(kill.sum())
            cap = rc.max_alpha * rc.min_transmittance
            kill_ok = (n_kill <= KILL_FLIP_CAP
                       and float(pix.max()) <= cap
                       and bool((torch.maximum(got[4], ref[4])[..., 0][kill]
                                 < rc.min_transmittance).all()))
            keep = ~kill
            err_f = float((got[0] - ref[0]).abs()[keep].max())
            err_o = float((got[1] - ref[1]).abs()[..., 0][keep].max())
            err_t = float((got[4] - ref[4]).abs()[..., 0][keep].max())
            err_d = float(((got[2] - ref[2]).abs()
                           / ref[2].abs().clamp(min=1e-3)).max())
            flips = float((got[3] != ref[3]).float().mean())
            # every ray starts at the mid-shutter centre: the shared-origin
            # table a = M (o - p) at that centre gives the same image
            center = v.ray_o[0, 0]
            shared = v.table.clone()
            m_mat = v.table[:, 3:12].reshape(-1, 3, 3)
            delta = center - v.table[:, 0:3]
            shared[:, 0:3] = (m_mat[:, :, 0] * delta[:, 0:1]
                              + m_mat[:, :, 1] * delta[:, 1:2]
                              + m_mat[:, :, 2] * delta[:, 2:3])
            same_origin = bool((v.ray_o == center).all())
            cross = float((rasterize_tiles_forward(shared, *args[1:7])[0]
                           - got[0]).abs().max())
            b_ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 20)
            b_plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*args), 2)
            share, cull, cull_msg = cull_check(
                args, f"general kernel B ({label})")
            if not (err_f <= 1e-4 and err_o <= 1e-4 and err_t <= 1e-4
                    and err_d <= 1e-3 and flips < 0.01 and kill_ok
                    and cross <= 1e-4 and same_origin):
                raise AssertionError(
                    f"general kernel B ({label}) vs plain: features "
                    f"{err_f:.3g}, opacity {err_o:.3g}, T_final {err_t:.3g},"
                    f" depth rel {err_d:.3g}, hits flip {flips:.4f}, kill "
                    f"flips {n_kill} (max |d| {float(pix.max()):.3g}, cap "
                    f"{cap:.3g}); vs shared-origin B {cross:.3g} (one "
                    f"origin {same_origin})")
            n_acc = composited(ref)
            win = rc.sort_window if rc.sorted_compositing else 0
            b_res = rgb_kernel_attributes("raster_fwd")[
                f"rgb_{rc.kernel_degree}_w{win}_general"]
            report["raster_fwd_general" + suffix] = dict(
                max_abs_err=float(pix.max()), ms=b_ms,
                plain_ms=b_plain_ms, culled_share=share, resources=b_res,
                **rgb_bound_keys(args, got, rc, cull, n_acc))
            msg_b.append(
                f"{label} (degree {rc.kernel_degree}, W "
                f"{rc.sort_window if rc.sorted_compositing else 0}), "
                f"{int(vb.num_pairs)} pairs: features |d| {err_f:.3g}, "
                f"opacity |d| {err_o:.3g}, T_final |d| {err_t:.3g}, depth "
                f"rel {err_d:.3g}, hits flip {flips:.5f}, kill flips "
                f"{n_kill} of {pix.numel()} pixels (max |d| "
                f"{float(pix.max()):.3g}); vs shared-origin "
                f"B at the mid-shutter centre |d| {cross:.3g}; kernel "
                f"{b_ms:.4f} ms, plain {b_plain_ms:.4f} ms; {cull_msg}; "
                f"{resources(b_res)}")
            # 20. general C, and D on its output
            c_args = args[:6] + (got[0], got[2], got[4], *upstream, rc,
                                 v.ray_o)
            d1 = rasterize_tiles_backward(*c_args)
            d2 = rasterize_tiles_backward(*c_args)
            d_ref = rasterize_tiles_backward_plain(*c_args)
            torch.cuda.synchronize()
            stats = grad_agreement(d1, d_ref, first="p")
            same = bool(torch.equal(d1, d2))
            c_err = float((d1 - d_ref).abs().max())
            c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 10)
            c_plain_ms = cuda_ms(
                lambda: rasterize_tiles_backward_plain(*c_args), 1)
            bad = {k: x for k, x in stats.items()
                   if not (x[0] >= 0.9999 and x[1] <= 1e-3)}
            if bad or not same:
                raise AssertionError(f"general kernel C ({label}) vs plain "
                                     f"(cosine, rel L2): {bad}; bitwise "
                                     f"repeatable {same}")
            res = rgb_kernel_attributes()[
                f"rgb_{rc.kernel_degree}_w{win}_general"]
            report["raster_bwd_general" + suffix] = dict(
                max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms,
                resources=res,
                **bound_keys(raster_bound(
                    c_args, [d1], rc, True, n_acc,
                    BWD_ACCEPT_FLOPS[(rc.kernel_degree, True)])))
            d_args = (d1, vb.perm, vb.order, vb.excl, vb.counts, vb.limit,
                      model.capacity, None, vb.num_pairs)
            d_keys, d_scale, _ = fold_check(
                lambda: fold_pairs(*d_args),
                lambda: fold_pairs_plain(*d_args), f"rolling {label}")
            lib_ms = index_add_ms(d_args)
            msg_c.append(f"{label}: " + ", ".join(
                f"{k} cos {x[0]:.8f} relL2 {x[1]:.3g}"
                for k, x in stats.items())
                + f"; max |d| {c_err:.3g}; two runs bitwise equal; kernel "
                f"{c_ms:.4f} ms, plain {c_plain_ms:.4f} ms; {resources(res)}"
                f"; kernel D on it: {fold_msg(d_keys, d_scale, lib_ms)}")
            # 21. general E
            e_args = args[:7] + (v.ray_o,)
            w1 = pair_weight_max(*e_args)
            w2 = pair_weight_max(*e_args)
            w_ref = pair_weight_max_plain(*e_args)
            torch.cuda.synchronize()
            # pairs of phase 19's kill-flip pixels may differ by up to
            # one contribution at the kill; 1e-6 holds on the others
            e_diff = (w1 - w_ref).abs()
            e_flip = e_diff > 1e-6
            n_e_flip = int(e_flip.sum())
            e_err = float(e_diff[~e_flip].max())
            e_same = bool(torch.equal(w1, w2))
            e_ms = cuda_ms(lambda: pair_weight_max(*e_args), 20)
            e_plain_ms = cuda_ms(lambda: pair_weight_max_plain(*e_args), 2)
            if not (e_same and n_e_flip <= KILL_FLIP_CAP
                    and float(e_diff.max()) <= cap):
                raise AssertionError(f"general kernel E ({label}) vs plain: "
                                     f"max |d| {float(e_diff.max()):.3g}, "
                                     f"{n_e_flip} pairs over 1e-6; bitwise "
                                     f"repeatable {e_same}")
            if label == "3DGUT":
                report["wmax_general"] = dict(
                    max_abs_err=float(e_diff.max()), ms=e_ms,
                    plain_ms=e_plain_ms, culled_share=share,
                    **rgb_bound_keys(e_args, [w1], rc, cull, n_acc))
            msg_e.append(f"{label}: max |d| {e_err:.3g} ({n_e_flip} pairs "
                         f"of kill-flip pixels up to "
                         f"{float(e_diff.max()):.3g}), two runs bitwise "
                         f"equal, {float((w1 > 0).float().mean()):.3f} of "
                         f"the pairs weighted; kernel {e_ms:.4f} ms, plain "
                         f"{e_plain_ms:.4f} ms; its cull is phase 19's "
                         f"(the same inputs): {share:.6f} culled")
            del v, got, ref, d1, d2, d_ref
    phase("general kernel B", f"rolling shutter {w}x{h}, 100k: "
          + "; ".join(msg_b))
    phase("general kernel C", "; ".join(msg_c))
    phase("general kernel E", "; ".join(msg_e))
    return report


def general_grad_phase(dev, ut_cfg):
    """Phase 22: the rolling-shutter render's gradients (general B, C,
    then D) against the JAX fixture, both settings."""
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.gut import render_gut

    msgs = []
    with np.load(SHUTTER_GRAD_FIXTURE) as f:
        for mode in ("3dgut", "grt"):
            rc = RasterConfig(**{
                k: f[f"{mode}/raster/{k}"].item() for k in (
                    "kernel_degree", "min_transmittance",
                    "sorted_compositing", "sort_window")
                if f"{mode}/raster/{k}" in f})
            gmodel = fixture_model(f, dev)
            cam = make_pinhole(
                tuple(int(x) for x in f["resolution"]), f["camera/focal"],
                f["camera/principal"], t=f["camera/t_start"],
                q=f["camera/q_start"], t_end=f["camera/t_end"],
                q_end=f["camera/q_end"],
                shutter_type=int(f["shutter_type"]), device=dev)
            out = render_gut(cam, ut_cfg, rc, gmodel, int(f["sh_degree"]))
            fixture_loss(out).backward()
            errs = {}
            for k in PARAM_NAMES:
                got_g = getattr(gmodel, k).grad.double().cpu().numpy()
                ref_g = f[f"{mode}/grad/{k}"].astype(np.float64)
                scale = np.abs(ref_g).max() + 1e-12
                cos = float((got_g * ref_g).sum() / max(
                    np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
                errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
            bad = {k: x for k, x in errs.items()
                   if not (x[0] <= 2e-3 and x[1] >= 0.9999)}
            if bad:
                raise AssertionError(f"rolling-shutter gradients vs JAX "
                                     f"({mode}; max-normalised error, "
                                     f"cosine): {bad}")
            msgs.append(f"{mode}: " + ", ".join(
                f"{k} {x[0]:.2g}/{x[1]:.7f}" for k, x in errs.items()))
    phase("rolling grad vs JAX", f"fixture "
          f"{os.path.basename(SHUTTER_GRAD_FIXTURE)}: " + "; ".join(msgs))


def camera_train_step_phase(dev, label, rc, camera, general):
    """Phase 23: the bench train step through ``camera`` (rolling or
    fisheye, synthetic.py:bench_camera) with ``rc``: 20 timed steps in
    which A and D launch 20 times, B and C 20 times in the expected mode
    and never in the other; 5 traced steps. Returns the general kernels'
    launches under their report names."""
    from bench_train_torch import BenchStep, profile_steps, time_steps
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)

    step = BenchStep(dev, rc, camera)
    time_steps(step, 3)                       # warm-up
    fns = (expand_decode_pairs, rasterize_tiles, rasterize_tiles_backward,
           fold_pairs)
    for fn in fns:
        fn.launches = 0
    for fn in fns[1:3]:
        fn.launches_general = 0
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    fwd, bwd = rasterize_tiles, rasterize_tiles_backward
    launches = {"bin_decode": expand_decode_pairs.launches,
                "raster_fwd": fwd.launches, "raster_bwd": bwd.launches,
                "raster_fwd_general": fwd.launches_general,
                "raster_bwd_general": bwd.launches_general,
                "fold": fold_pairs.launches}
    n = TRAIN_STEPS
    want = dict(bin_decode=n, raster_fwd=0 if general else n,
                raster_bwd=0 if general else n,
                raster_fwd_general=n if general else 0,
                raster_bwd_general=n if general else 0, fold=n)
    if launches != want:
        raise AssertionError(f"{label} train-step launches {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError(f"{label} train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"{label} train-step gradient of {k} is "
                                 "not finite and non-zero")
    wall_us, busy_us, n_device = profile_steps(step, 5, top=8)
    w, h = step.cam.resolution
    phase(f"{label} train step", f"100k Gaussians, {w}x{h}, SH 3, "
          f"L1+DSSIM, Adam, degree {rc.kernel_degree}, W "
          f"{rc.sort_window if rc.sorted_compositing else 0}: "
          f"{step_ms:.3f} ms/step ({1e3 / step_ms:.2f} it/s) host clock over "
          f"{TRAIN_STEPS} steps; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; launches {launches}; 5 traced steps: "
          f"wall {wall_us:.1f} us/step, device busy {busy_us:.1f} us/step, "
          f"idle share {1.0 - busy_us / wall_us:.3f}, {n_device:.1f} device "
          f"kernels per step")
    return launches


def camera_serving_phase(dev, model, ut_cfg, camera, general):
    """Phase 24's serving: 8 orbit views of ``camera`` through
    make_serving_renderer; kernel B launched once per view, in the
    general mode for the rolling shutter."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import orbit_cameras

    cams = orbit_cameras(model, N_VIEWS, camera, device=dev)
    serve = make_serving_renderer(model, RasterConfig(), sh_degree=3,
                                  ut_cfg=ut_cfg)
    serve(cams)
    torch.cuda.synchronize()
    rasterize_tiles.launches = rasterize_tiles.launches_general = 0
    t0 = time.perf_counter()
    imgs = serve(cams)
    torch.cuda.synchronize()
    per_batch = [(time.perf_counter() - t0) * 1e3 / N_VIEWS]
    got = (rasterize_tiles.launches, rasterize_tiles.launches_general)
    want = (0, N_VIEWS) if general else (N_VIEWS, 0)
    for _ in range(2):
        t0 = time.perf_counter()
        serve(cams)
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3 / N_VIEWS)
    w, h = cams[0].resolution
    if got != want:
        raise AssertionError(f"{camera} serving launches (shared-origin, "
                             f"general) {got}, expected {want}")
    if tuple(imgs.shape) != (N_VIEWS, h, w, 3) or not bool(
            torch.isfinite(imgs).all()):
        raise AssertionError(f"{camera} serving output {tuple(imgs.shape)} "
                             "not finite or of the wrong shape")
    coverage = min(float((im.amax(dim=-1) > 1e-3).float().mean())
                   for im in imgs)
    if coverage < 0.05:
        raise AssertionError(f"{camera} serving coverage {coverage}")
    phase(f"{camera} serving", f"{N_VIEWS} views {w}x{h}, 100k, SH 3: "
          f"median {float(np.median(per_batch)):.3f} ms/frame host clock "
          f"over 3 batches ({', '.join(f'{x:.3f}' for x in per_batch)}); "
          f"kernel B launches (shared-origin, general) {got}; coverage min "
          f"{coverage:.3f}")
    return got


def cli_phase(dev):
    """Phase 25: train_torch.py --config-name apps/scannetpp_3dgut on a
    generated 6-view fisheye ScanNet++ capture at 1752x1168 (COLMAP
    points from the teacher), 30 steps: exit 0, checkpoint written."""
    import shutil

    from threedgrut_tpu_torch.synthetic import (build_teacher,
                                                teacher_dataset,
                                                write_colmap_scene)

    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "smoke_scannetpp")
    shutil.rmtree(root, ignore_errors=True)
    teacher = build_teacher(60000, seed=0, device=dev)
    # on black, the background the config trains against
    ds = teacher_dataset(teacher, n_views=6, camera="fisheye",
                         background=0.0)
    write_colmap_scene(os.path.join(root, "data"), ds, teacher,
                       n_points=20000)
    gen_s = time.perf_counter() - t0
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "train_torch.py"),
         "--config-name", "apps/scannetpp_3dgut",
         f"path={os.path.join(root, 'data')}", "n_iterations=30",
         f"out_dir={out}", "experiment_name=smoke", "log_frequency=0.1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    ckpt = os.path.join(out, "smoke", "ckpt_last.npz")
    if res.returncode != 0 or not os.path.exists(ckpt):
        raise AssertionError(f"scannetpp CLI: exit {res.returncode}\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    with np.load(ckpt) as f:
        steps, n_active = int(f["global_step"]), int(f["n_active"])
    last = [ln for ln in res.stdout.splitlines() if ln.strip()][-1:]
    phase("scannetpp CLI", f"6 fisheye views 1752x1168 written in "
          f"{gen_s:.1f} s; train_torch.py apps/scannetpp_3dgut, COLMAP init "
          f"({n_active} Gaussians at the end), {steps} steps, exit 0 in "
          f"{cli_s:.1f} s; {last}")
    shutil.rmtree(root, ignore_errors=True)


NHT_GRAD_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                "torch_port_nht_grad_small.npz")
NHT_NAMES = ("positions", "rotation", "scale", "density", "features")
# label -> report-name suffix, config of the two NHT settings
NHT_CONFIGS = {"3DGUT": ("", "apps/nerf_synthetic_3dgut_mcmc_nht"),
               "3DGRT": ("_grt", "apps/nerf_synthetic_3dgrt_mcmc_nht")}
# the NHT record's gradient field groups (p, M, density, 48 features)
# kernel C's NHT sine and cosine against float64 (raster_bwd.cu:
# sincos_fast: CUDA states 3.6e-7 for the SFU on [-pi, pi], the
# reduction adds up to 1.2e-7)
NHT_SINCOS_TOL = 1e-6
NHT_GROUPS = {"p": slice(0, 3), "M": slice(3, 12), "density": slice(12, 13),
              "features": slice(13, 61)}


def nht_settings():
    """{label: RasterConfig} of the two NHT configs, as render_gut runs
    them (train_torch.py's mapping, unsorted: NHT composites in global-Z
    order)."""
    from threedgrut_tpu_torch.config.loader import load_config
    from train_torch import trainer_config

    return {label: trainer_config(load_config(
        name, overrides=["path=none"])).raster.replace(
            sorted_compositing=False)
        for label, (_, name) in NHT_CONFIGS.items()}


def nht_kernel_phases(dev, ut_cfg, cam):
    """Phases 26-27: NHT kernels B and C on the 800x800 view of the 100k
    NHT cloud against their float64 plain versions, at both settings,
    and the 64-wide kernel D on C's output. Returns the report
    entries."""
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs, fold_pairs_plain
    from threedgrut_tpu_torch.ops.cuda.raster import (
        nht_fwd_kernel_attributes, nht_kernel_attributes,
        rasterize_tiles_backward,
        rasterize_tiles_backward_plain, rasterize_tiles_forward,
        rasterize_tiles_plain)
    from threedgrut_tpu_torch.synthetic import nht_cloud

    sin_err = nht_sincos_error(dev)
    attrs = nht_kernel_attributes()
    b_attrs = nht_fwd_kernel_attributes()
    model = nht_cloud(100_000, seed=0, device=dev)
    w, h = cam.resolution
    upstream = seeded_upstream(dev, h, w, (24, 1, 1), 26)
    report, msg_b, msg_c = {}, [], []
    for label, rc in nht_settings().items():
        suffix = NHT_CONFIGS[label][0]
        v, args, got, c_args = view_inputs(cam, ut_cfg, rc, model, 0,
                                           upstream)
        if v.ray_o is None or v.table.shape[1] != 64:
            raise AssertionError("NHT took the shared-origin mode")
        vb = v.binning
        with torch.no_grad():
            # 26. NHT B; kill flips as in phase 19
            ref, b_plain_ms = timed_once(lambda: rasterize_tiles_plain(*args))
            pix = torch.maximum(torch.maximum(
                (got[0] - ref[0]).abs().amax(-1),
                (got[1] - ref[1]).abs()[..., 0]),
                (got[4] - ref[4]).abs()[..., 0])
            kill = pix > 1e-4
            n_kill = int(kill.sum())
            cap = rc.max_alpha * rc.min_transmittance
            kill_ok = (n_kill <= KILL_FLIP_CAP and float(pix.max()) <= cap
                       and bool((torch.maximum(got[4], ref[4])[..., 0][kill]
                                 < rc.min_transmittance).all()))
            keep = ~kill
            err_f = float((got[0] - ref[0]).abs()[keep].max())
            err_o = float((got[1] - ref[1]).abs()[..., 0][keep].max())
            err_t = float((got[4] - ref[4]).abs()[..., 0][keep].max())
            err_d = float(((got[2] - ref[2]).abs()
                           / ref[2].abs().clamp(min=1e-3)).max())
            flips = float((got[3] != ref[3]).float().mean())
            b_ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 20)
            if not (got[0].shape == (h, w, 24) and err_f <= 1e-4
                    and err_o <= 1e-4 and err_t <= 1e-4 and err_d <= 1e-3
                    and flips < 0.01 and kill_ok):
                raise AssertionError(
                    f"NHT kernel B ({label}) vs plain: features {err_f:.3g},"
                    f" opacity {err_o:.3g}, T_final {err_t:.3g}, depth rel "
                    f"{err_d:.3g}, hits flip {flips:.4f}, kill flips "
                    f"{n_kill} (max |d| {float(pix.max()):.3g})")
            n_acc = composited(ref)
            b_res = b_attrs[f"nht{rc.kernel_degree}"]
            report["raster_fwd_nht" + suffix] = dict(
                max_abs_err=float(pix.max()), ms=b_ms, plain_ms=b_plain_ms,
                resources=b_res,
                **bound_keys(raster_bound(args, got, rc, True, n_acc,
                                          NHT_ACCEPT_FLOPS)))
            msg_b.append(
                f"{label} (degree {rc.kernel_degree}), {int(vb.num_pairs)} "
                f"pairs, {n_acc:.0f} composited: features |d| {err_f:.3g}, "
                f"opacity |d| {err_o:.3g}, T_final |d| {err_t:.3g}, depth "
                f"rel {err_d:.3g}, hits flip {flips:.5f}, kill flips "
                f"{n_kill}; kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms; "
                f"{resources(b_res)}")
            # 27. NHT C, then the 64-wide D on its output
            d1 = rasterize_tiles_backward(*c_args)
            d2 = rasterize_tiles_backward(*c_args)
            d_ref, c_plain_ms = timed_once(
                lambda: rasterize_tiles_backward_plain(*c_args))
            stats = {}
            for nm, sl in NHT_GROUPS.items():
                x = d1[:, sl].double().flatten()
                y = d_ref[:, sl].double().flatten()
                stats[nm] = (
                    float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300)),
                    float((x - y).norm() / y.norm().clamp(min=1e-300)))
            same = bool(torch.equal(d1, d2))
            c_err = float((d1 - d_ref).abs().max())
            c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 10)
            bad = {k: x for k, x in stats.items()
                   if not (x[0] >= 0.9999 and x[1] <= 1e-3)}
            if bad or not same or float(d1[:, 61:].abs().max()) != 0.0:
                raise AssertionError(f"NHT kernel C ({label}) vs plain "
                                     f"(cosine, rel L2): {bad}; bitwise "
                                     f"repeatable {same}")
            res = attrs[f"nht{rc.kernel_degree}"]
            report["raster_bwd_nht" + suffix] = dict(
                max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms,
                **bound_keys(raster_bound(c_args, [d1], rc, True, n_acc,
                                          NHT_BWD_ACCEPT_FLOPS)),
                resources=res, sincos_max_abs_err=sin_err[0],
                sincos_accurate_max_abs_err=sin_err[1])
            msg = (f"{label}: " + ", ".join(
                f"{k} cos {x[0]:.8f} relL2 {x[1]:.3g}"
                for k, x in stats.items())
                + f"; max |d| {c_err:.3g}; two runs bitwise equal; kernel "
                f"{c_ms:.4f} ms, plain {c_plain_ms:.4f} ms; {resources(res)}")
            if label == "3DGUT":
                d_args = (d1, vb.perm, vb.order, vb.excl, vb.counts,
                          vb.limit, model.capacity, None, vb.num_pairs)
                f_keys, f_scale, f1 = fold_check(
                    lambda: fold_pairs(*d_args),
                    lambda: fold_pairs_plain(*d_args), "64 wide")
                if f1.shape[1] != 64:
                    raise AssertionError(f"NHT rows {f1.shape[1]} wide")
                f_lib = index_add_ms(d_args)
                report["fold_64"] = dict(
                    **f_keys, **bound_keys(fold_bound(
                        d1, int(vb.num_pairs),
                        (vb.perm, *d_args[2:5], vb.num_pairs), f1),
                        library_ms=f_lib))
                msg += (f"; kernel D 64 wide: "
                        f"{fold_msg(f_keys, f_scale, f_lib)}")
            msg_c.append(msg)
            del v, got, ref, d1, d2, d_ref
    phase("NHT kernel B", f"{w}x{h} pinhole (general mode), 100k, 48 NHT "
          "features: " + "; ".join(msg_b))
    phase("NHT kernels C and D", "; ".join(msg_c) + f"; C's sine and "
          f"cosine within {sin_err[0]:.3g} of float64 for |x| <= 2^20 "
          f"(the fast path), {sin_err[1]:.3g} past it (sincosf)")
    return report


def nht_sincos_error(dev):
    """Kernel C's NHT sine and cosine against float64: (the largest
    absolute error of raster_bwd.cu:sincos_fast on 4M seeded and 2M evenly
    spaced arguments of its range, |x| <= 2^20; that of the accurate
    sincosf past it on 1M arguments up to 1e9), each held to
    NHT_SINCOS_TOL."""
    from threedgrut_tpu_torch.ops.cuda.raster import (NHT_TRIG_FAST_MAX,
                                                      nht_sincos)

    rng = np.random.default_rng(27)
    lim = NHT_TRIG_FAST_MAX
    errs = []
    for x in (np.concatenate([rng.uniform(-lim, lim, 4_000_000),
                              np.linspace(-lim, lim, 2_000_001)]),
              rng.uniform(lim, 1e9, 1_000_000) * rng.choice((-1, 1),
                                                            1_000_000)):
        x = x.astype(np.float32)
        s, c = nht_sincos(torch.tensor(x, device=dev))
        xd = x.astype(np.float64)
        errs.append(max(float(np.abs(s.cpu().numpy() - np.sin(xd)).max()),
                        float(np.abs(c.cpu().numpy() - np.cos(xd)).max())))
    if not max(errs) <= NHT_SINCOS_TOL:
        raise AssertionError(f"NHT sine and cosine: max |d| {errs} of "
                             f"float64 (limit {NHT_SINCOS_TOL:g})")
    return errs


def nht_grad_phase(dev, ut_cfg):
    """Phase 28: the NHT render's gradients (NHT B, C, then 64-wide D)
    against the JAX fixture."""
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.ops.cameras import make_pinhole
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.gut import render_gut

    with np.load(NHT_GRAD_FIXTURE) as f:
        arrays = {k: f[f"params/{k}"] for k in NHT_NAMES}
        cfg = GaussianModelConfig(
            density_activation=str(f["density_activation"]),
            scale_activation=str(f["scale_activation"]), feature_type="nht",
            nht_feature_dim=arrays["features"].shape[1])
        model = GaussianModel.from_numpy(arrays, int(f["n_active"]), 0, cfg,
                                         dev)
        cam = make_pinhole(tuple(int(x) for x in f["resolution"]),
                           f["focal"], f["principal"], t=f["t"], q=f["q"],
                           device=dev)
        out = render_gut(cam, ut_cfg, RasterConfig(), model, 0)
        fixture_loss(out).backward()
        errs = {}
        for k in NHT_NAMES:
            got_g = getattr(model, k).grad.double().cpu().numpy()
            ref_g = f[f"grad/{k}"].astype(np.float64)
            scale = np.abs(ref_g).max() + 1e-12
            cos = float((got_g * ref_g).sum() / max(
                np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
            errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
    bad = {k: x for k, x in errs.items()
           if not (x[0] <= 2e-3 and x[1] >= 0.9999)}
    if bad:
        raise AssertionError(f"NHT gradients vs JAX (max-normalised error, "
                             f"cosine): {bad}")
    phase("NHT grad vs JAX", f"fixture {os.path.basename(NHT_GRAD_FIXTURE)}"
          ": " + ", ".join(f"{k} {x[0]:.2g}/{x[1]:.7f}"
                           for k, x in errs.items()))


def nht_train_step_phase(dev, label):
    """Phase 29: the NHT + MCMC bench step of one NHT config: 20 timed
    steps in which A, NHT B and C and the 64-wide D launch 20 times and
    no other mode of B, C and D; 5 traced steps. Returns the NHT
    kernels' launches under their report names."""
    from bench_train_torch import config_step, profile_steps, time_steps
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)

    suffix, name = NHT_CONFIGS[label]
    step = config_step(name, dev)
    time_steps(step, 3)                       # warm-up
    fwd, bwd = rasterize_tiles, rasterize_tiles_backward
    counters = {"bin_decode": (expand_decode_pairs, "launches"),
                "raster_fwd_nht": (fwd, "launches_nht"),
                "raster_bwd_nht": (bwd, "launches_nht"),
                "fold_64": (fold_pairs, "launches_wide"),
                "raster_fwd": (fwd, "launches"),
                "raster_fwd_general": (fwd, "launches_general"),
                "raster_bwd": (bwd, "launches"),
                "raster_bwd_general": (bwd, "launches_general"),
                "fold": (fold_pairs, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    want = {k: TRAIN_STEPS if k in ("bin_decode", "raster_fwd_nht",
                                    "raster_bwd_nht", "fold_64") else 0
            for k in counters}
    if launches != want:
        raise AssertionError(f"NHT {label} train-step launches {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError(f"NHT {label} train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"NHT {label} train-step gradient of {k} "
                                 "is not finite and non-zero")
    wall_us, busy_us, n_device = profile_steps(step, 5, top=10)
    phase(f"NHT {label} train step", f"{name}: 100k Gaussians, 48 NHT "
          f"features, {SIDE}x{SIDE}, degree {step.rc.kernel_degree}, decoder "
          f"+ EMA, L1+DSSIM, Adam, MCMC perturb: {step_ms:.3f} ms/step "
          f"({1e3 / step_ms:.2f} it/s) host clock over {TRAIN_STEPS} steps; "
          f"loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}; launches "
          f"{launches}; 5 traced steps: wall {wall_us:.1f} us/step, device "
          f"busy {busy_us:.1f} us/step, idle share "
          f"{1.0 - busy_us / wall_us:.3f}, {n_device:.1f} device kernels per "
          f"step")
    return {k + suffix: launches[k] for k in ("raster_fwd_nht",
                                              "raster_bwd_nht")} | (
        {"fold_64": launches["fold_64"]} if label == "3DGUT" else {})


def nht_trainer_phase(dev):
    """Phase 30: the apps/nerf_synthetic_3dgut_mcmc_nht trainer from 100k
    random Gaussians on 8 teacher views (white background) at 800x800,
    260 steps: warmup 20 and color refine 26 (the config's 1000 and 3000
    would freeze the geometry throughout), relocate and add at steps 100,
    150 and 200, the EMA on."""
    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.models.background import BackgroundConfig
    from threedgrut_tpu_torch.synthetic import build_teacher, teacher_dataset
    from threedgrut_tpu_torch.train.trainer import Trainer
    from train_torch import make_model, trainer_config

    t0 = time.perf_counter()
    ds = teacher_dataset(build_teacher(60000, seed=0, device=dev),
                         n_views=8, side=SIDE)
    conf = load_config(NHT_CONFIGS["3DGUT"][1], overrides=[
        "path=none", "initialization.num_gaussians=100000"])
    tconf = trainer_config(conf)
    tconf.n_iterations = 260
    tconf.nht_warmup_steps = 20
    tconf.nht_color_refine_steps = 26
    tconf.background = BackgroundConfig(color="white")
    tconf.mcmc = tconf.mcmc.replace(relocate_start=50, relocate_frequency=50,
                                    relocate_end=210, add_start=50,
                                    add_frequency=50, add_end=210)
    trainer = Trainer(tconf, ds, make_model(conf, ds, dev))
    n0 = trainer.model.n_active
    hist = trainer.run_training(260)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    val = trainer.validate()
    events = trainer.event_stats
    relocs = [st for _, kind, st in events if kind == "relocate"]
    adds = [st for _, kind, st in events if kind == "add"]
    early = float(np.mean([h_["psnr"] for h_ in hist[0:20]]))
    late = float(np.mean([h_["psnr"] for h_ in hist[229:249]]))
    checks = {
        "three relocate and add events": len(relocs) == 3 and len(adds) == 3,
        "no whole-cloud relocation": all(
            st["n_relocated"] < st["n_active"] for st in relocs),
        "add grew the cloud": trainer.model.n_active > n0,
        "psnr +2 dB": late >= early + 2.0,
        "finite": all(np.isfinite(h_["total"]) for h_ in hist),
        "EMA validate finite": bool(np.isfinite(val["psnr"])),
    }
    summary = (f"{SIDE}x{SIDE}, {len(hist)} steps in {train_s:.1f} s, "
               f"capacity {trainer.model.capacity}; events "
               + "; ".join(f"[{s_}] {k} " + " ".join(
                   f"{a}={b}" for a, b in st.items())
                   for s_, k, st in events)
               + f"; psnr steps 1-20 {early:.2f} dB, 230-249 {late:.2f} dB; "
               f"validate (EMA decoder, train views) psnr "
               f"{val['psnr']:.2f} dB")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"NHT trainer: {failed} ({summary})")
    phase("NHT trainer", summary)


# trace()'s path (render/grt.py) and the playground: the orbit view's rays
# at TRACE_SIDE
TRACE_SIDE = 512
# blended normals against their references: every pixel within
# NORMALS_TOL but at most NORMALS_CAP, and those within NORMALS_MAX (the
# CPU tests' tolerance against JAX). fp32 loses digits where the ray's
# origin lies hundreds of particle radii away: the entry point a + b t
# (|a| in the hundreds, the result at most 3) cancels them
NORMALS_TOL = 3e-4
NORMALS_CAP = 8
NORMALS_MAX = 2e-3
TRACE_GRAD_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                  "torch_port_trace_grad_small.npz")


def trace_rays(model):
    """World rays [TRACE_SIDE, TRACE_SIDE, 3] of the first orbit view
    around the live cloud (synthetic.py:orbit_cameras)."""
    from threedgrut_tpu_torch.render.common import camera_rays_world
    from threedgrut_tpu_torch.synthetic import orbit_cameras

    cam = orbit_cameras(model, 1, resolution=(TRACE_SIDE, TRACE_SIDE),
                        device=model.device)[0]
    return camera_rays_world(cam)


def normals_agreement(n_err):
    """(ok, a message) of per-pixel normals errors ``n_err`` against
    NORMALS_TOL, NORMALS_CAP and NORMALS_MAX."""
    n_over = int((n_err > NORMALS_TOL).sum())
    top = float(n_err.max()) if n_err.numel() else 0.0
    return (n_over <= NORMALS_CAP and top <= NORMALS_MAX,
            f"normals max |d| {top:.3g}, {n_over} pixels over "
            f"{NORMALS_TOL:g}, median {float(n_err.median()):.3g}")


def forward_agreement(got, ref, rc, label):
    """Kernel B against its plain version, kill flips counted as phase
    19 counts them; raises past the tolerances. Normals (a sixth output;
    the plain version's in the kernel's fp32 operation order) by
    ``normals_agreement``. Returns (max |d|, a message)."""
    pix = torch.maximum(torch.maximum(
        (got[0] - ref[0]).abs().amax(-1), (got[1] - ref[1]).abs()[..., 0]),
        (got[4] - ref[4]).abs()[..., 0])
    n_msg, n_ok = "", True
    if len(got) > 5:
        n_ok, n_msg = normals_agreement((got[5] - ref[5]).abs().amax(-1))
        n_msg = ", " + n_msg
    kill = pix > 1e-4
    n_kill = int(kill.sum())
    kill_ok = (n_kill <= KILL_FLIP_CAP
               and float(pix.max()) <= max(rc.max_alpha
                                           * rc.min_transmittance, 1e-4)
               and bool((torch.maximum(got[4], ref[4])[..., 0][kill]
                         < rc.min_transmittance).all()))
    err = float(pix[~kill].max())
    err_d = float(((got[2] - ref[2]).abs()
                   / ref[2].abs().clamp(min=1e-3)).max())
    flips = float((got[3] != ref[3]).float().mean())
    msg = (f"max |d| {err:.3g} (features, opacity, T_final), depth rel "
           f"{err_d:.3g}, hits flip {flips:.5f}, kill flips {n_kill}{n_msg}")
    if not (err <= 1e-4 and err_d <= 1e-3 and flips < 0.01 and kill_ok
            and n_ok):
        raise AssertionError(f"{label} vs plain: {msg}")
    return float(pix.max()), msg


def backward_agreement(c_args, d_rows, label):
    """Kernel C's rows ``d_rows`` against the float64 plain backward on
    the same arguments ``c_args``, every block: cosine >= 0.9999 and
    relative L2 <= 1e-3 per field group, none of them all zero. Returns
    (max |d|, plain ms, a message)."""
    from threedgrut_tpu_torch.ops.cuda.raster import \
        rasterize_tiles_backward_plain

    d_ref, plain_ms = timed_once(
        lambda: rasterize_tiles_backward_plain(*c_args))
    stats = grad_agreement(d_rows, d_ref, first="p")
    bad = {k: x for k, x in stats.items()
           if not (x[0] >= 0.9999 and x[1] <= 1e-3)}
    if bad:
        raise AssertionError(f"{label} vs plain (cosine, rel L2): {bad}")
    err = float((d_rows - d_ref).abs().max())
    return err, plain_ms, ", ".join(f"{k} cos {x[0]:.8f} relL2 {x[1]:.3g}"
                                    for k, x in stats.items())


def cull_check(args, label):
    """The cull of a launch (kernels B and E in their RGB modes, trace's B
    and C at windows of 128) on a phase's own inputs ``args``: its plain
    mirror in the kernels' fp32 operation order and the fp32 exact test,
    on the card (ops/cuda/raster.py:cull_plain); raises if it ever culls
    a candidate the exact test accepts. Returns (the share of (pair,
    pixel) tests culled, the mirror's counts, a message)."""
    from threedgrut_tpu_torch.ops.cuda.raster import TRACE_K, cull_plain

    c = cull_plain(*args)
    if c["culled_accepted"]:
        raise AssertionError(f"{label}: the cull drops {c['culled_accepted']}"
                             f" accepted candidates: {c}")
    n = c["tests"]
    share = (c["bundle_culled"] + c["sphere_culled"]) / n
    return share, c, (
        f"cull {share:.6f} of {n} (pair, pixel) tests ({c['bundle_culled'] / n:.6f}"
        f" by the warps' bundles, {c['sphere_culled'] / n:.6f} by the rays' "
        f"spheres), 0 of the {c['accepted']} accepted culled; "
        f"{c['over_k']} (ray, window) with more than {TRACE_K} accepted "
        f"(at most {c['max_window']}); the work of the walked windows: "
        f"{c['staged']} staged pairs, {c['bundle_tests']} pyramid tests, "
        f"{c['sphere_tests']} sphere tests, {c['exact_tests']} exact tests")


def trace_path_run(model, ro, rd, counters, **kw):
    """trace's main path once, as a user calls it: forward and the
    backward of fixture_loss, with ``counters`` (name -> (function,
    attribute)) set to 0 just before and read just after. Returns (the
    launches, ms of a forward call, host clock over 3 calls)."""
    from threedgrut_tpu_torch.render.grt import trace

    for p in model.params().values():
        p.grad = None
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    out = trace(model, ro, rd, **kw)
    fixture_loss(out).backward()
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    with torch.no_grad():
        return launches, host_ms(lambda: trace(model, ro, rd, **kw), 3), out


def trace_phases(dev, ut_cfg):
    """Phases 31-35: trace()'s kernels at the playground's size against
    their plain versions, the JAX gradient fixture, the trace path's
    launches, and the grid against brute force. Returns (report entries,
    launches)."""
    from threedgrut_tpu_torch.ops.cuda.fold import (
        fold_pairs, fold_pairs_plain, fold_shared_segment, invert_permutation)
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward, rasterize_tiles_forward,
        rasterize_tiles_plain, repeat_fold, trace_kernel_attributes,
        window_overflows)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import prepare_trace, trace
    from threedgrut_tpu_torch.render.oracle import oracle_probe, parity_db
    from threedgrut_tpu_torch.synthetic import bench_cloud

    report, launches = {}, {}
    fwd_fn, bwd_fn = rasterize_tiles, rasterize_tiles_backward
    n_blocks = TRACE_SIDE * TRACE_SIDE // 256
    rng = np.random.default_rng(31)
    upstream = [torch.tensor(rng.normal(size=(16 * n_blocks, 16, c)).astype(
        np.float32), device=dev) for c in (3, 1, 1)]

    # 31. kernel 7 forward: brute force over 8192 slots, windows of 128
    small = bench_cloud(8192, seed=0, device=dev)
    ro, rd = trace_rays(small)
    with torch.enable_grad():
        inp = prepare_trace(small, ro, rd)
    if not (inp.shared and inp.fold is not None):
        raise AssertionError("8192 slots did not take the brute force")
    args = inp.args()
    with torch.no_grad():
        window_overflows(reset=True)
        got = rasterize_tiles_forward(*args)
        b_over = window_overflows(reset=True)["raster_fwd"]
        ref, plain_ms = timed_once(lambda: rasterize_tiles_plain(*args))
        err, msg = forward_agreement(got, ref, inp.cfg, "kernel 7 B")
        b_ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 5)
        brute_share, brute_cull, cull_msg = cull_check(args, "kernel 7")
    n_seg = int(inp.tile_start[1])
    n_acc = composited(ref)
    report["raster_fwd_shared_segment"] = dict(
        max_abs_err=err, ms=b_ms, plain_ms=plain_ms, culled_share=brute_share,
        **cull_bound_keys(args, got, inp.cfg, brute_cull, n_acc,
                          shared_tiles=n_blocks))
    att = trace_kernel_attributes()
    phase("kernel 7 B", f"brute force, {n_seg} slots x {n_blocks} blocks of "
          f"256 rays ({TRACE_SIDE}x{TRACE_SIDE} orbit view), W 128, degree "
          f"4, {n_acc:.0f} composited: {msg}; kernel {b_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; {cull_msg}; k-buffer overflow passes "
          f"{b_over}; trace kernels (registers, local bytes, shared bytes, "
          f"dynamic shared bytes): " + ", ".join(
              f"{k} {v['registers']}/{v['local_bytes']}/{v['shared_bytes']}/"
              f"{v['dynamic_shared_bytes']}" for k, v in att.items()))

    # 32. kernel 7 backward: C over the shared segment, then D
    with torch.no_grad():
        c_args = args[:6] + (got[0], got[2], got[4], *upstream, inp.cfg,
                             inp.ray_o, True)
        d1 = rasterize_tiles_backward(*c_args)
        c_over = window_overflows(reset=True)["raster_bwd"]
        d2 = rasterize_tiles_backward(*c_args)
        same = bool(torch.equal(d1, d2))
        del d2
        c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 3)
        c_err, c_plain_ms, c_msg = backward_agreement(c_args, d1,
                                                      "kernel 7 C")
        if not same or d1.shape[0] != n_blocks * n_seg:
            raise AssertionError(f"kernel 7 C: bitwise repeatable {same}, "
                                 f"rows {d1.shape[0]}")
        # D's shared-segment mode, as the backward calls it, against the
        # plain composition: the segment's fold repeated per block
        fm, cap = inp.fold, inp.table.shape[0]
        g = repeat_fold(fm, n_blocks)
        d_args = (d1, g.perm, g.order, g.excl, g.counts, g.limit, cap)
        f_keys, f_scale, f1 = fold_check(
            lambda: fold_shared_segment(d1, n_blocks, fm.order, fm.excl,
                                        fm.counts, fm.limit, cap),
            lambda: fold_pairs_plain(*d_args), "kernel 7's rows", 10)
        f_lib = index_add_ms(d_args)
        n_owned = int(fm.counts.sum())      # the slots some rank owns
    report["raster_bwd_shared_segment"] = dict(
        max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms,
        culled_share=brute_share,
        **cull_bound_keys(c_args, [d1], inp.cfg, brute_cull, n_acc,
                          shared_tiles=n_blocks))
    # the bound: the blocks' rows of the owned slots, the segment's fold
    # and the output (not repeat_fold's permutation of every row)
    report["fold_shared_segment"] = dict(
        **f_keys, **bound_keys(fold_bound(
            d1, n_blocks * n_owned, (fm.inv_perm, fm.order, fm.excl,
                                     fm.counts), f1), library_ms=f_lib))
    del d1, f1, d_args, g
    # the sorted trace's gradients against JAX's sorted vjp
    with np.load(TRACE_GRAD_FIXTURE) as f:
        gmodel = fixture_model(f, dev)
        out = trace(gmodel, torch.tensor(f["ray_o"], device=dev),
                    torch.tensor(f["ray_d"], device=dev),
                    sh_degree=int(f["sh_degree"]))
        fixture_loss(out).backward()
        errs = {}
        for k in PARAM_NAMES:
            got_g = getattr(gmodel, k).grad.double().cpu().numpy()
            ref_g = f[f"grad/{k}"].astype(np.float64)
            scale = np.abs(ref_g).max() + 1e-12
            cos = float((got_g * ref_g).sum() / max(
                np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
            errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
    bad = {k: x for k, x in errs.items()
           if not (x[0] <= 2e-3 and x[1] >= 0.9999)}
    if bad:
        raise AssertionError(f"trace gradients vs JAX: {bad}")
    counters = {"raster_fwd_shared_segment": (fwd_fn,
                                              "launches_shared_segment"),
                "raster_bwd_shared_segment": (bwd_fn,
                                              "launches_shared_segment"),
                "fold_shared_segment": (fold_shared_segment, "launches")}
    got_l, brute_ms, _ = trace_path_run(small, ro, rd, counters)
    if got_l != {k: 1 for k in counters}:
        raise AssertionError(f"brute trace launches {got_l}")
    launches.update(got_l)
    phase("kernel 7 C and D", f"C: {c_msg} (all {n_blocks} blocks); max "
          f"|d| {c_err:.3g}; k-buffer overflow passes {c_over}; two runs "
          f"bitwise equal; kernel {c_ms:.4f} ms, "
          f"plain {c_plain_ms:.4f} ms; D on its {n_blocks * n_seg} rows "
          f"(shared-segment mode, against repeat_fold + the plain fold): "
          f"{fold_msg(f_keys, f_scale, f_lib)}; gradients vs "
          f"{os.path.basename(TRACE_GRAD_FIXTURE)} (sorted): " + ", ".join(
              f"{k} {x[0]:.2g}/{x[1]:.7f}" for k, x in errs.items())
          + f"; trace path (forward + backward) launches {got_l}; "
          f"{brute_ms:.3f} ms per forward trace call (host clock)")

    # 33. windows of 128 in the grid at 100k
    big = bench_cloud(100_000, seed=0, device=dev)
    ro, rd = trace_rays(big)
    with torch.enable_grad():
        inp = prepare_trace(big, ro, rd)
    if inp.shared:
        raise AssertionError("100k slots did not take the grid")
    args = inp.args()
    seg_len = int(inp.tile_start[1])
    with torch.no_grad():
        window_overflows(reset=True)
        got = rasterize_tiles_forward(*args)
        b_over = window_overflows(reset=True)["raster_fwd"]
        ref, plain_ms = timed_once(lambda: rasterize_tiles_plain(*args))
        err, msg = forward_agreement(got, ref, inp.cfg, "W 128 B")
        b_ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 5)
        n_acc = composited(ref)
        c_args = args[:6] + (got[0], got[2], got[4], *upstream, inp.cfg,
                             inp.ray_o, False)
        d1 = rasterize_tiles_backward(*c_args)
        c_over = window_overflows(reset=True)["raster_bwd"]
        same = bool(torch.equal(d1, rasterize_tiles_backward(*c_args)))
        c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 3)
        c_err, c_plain_ms, c_msg = backward_agreement(c_args, d1,
                                                      "W 128 C")
        if not same:
            raise AssertionError("W 128 C is not bitwise repeatable")
        grid_share, grid_cull, cull_msg = cull_check(args, "W 128")
        # D on the grid's rows as the backward calls it: the pairs name
        # particles directly, the inverse is the caller's sort's
        fm, cap = inp.fold, inp.table.shape[0]
        g_args = (d1, None, fm.order, fm.excl, fm.counts, fm.limit, cap,
                  fm.inv_perm)
        g_keys, g_scale, g1 = fold_check(lambda: fold_pairs(*g_args),
                                         lambda: fold_pairs_plain(*g_args),
                                         "the grid trace's rows")
        g_lib = index_add_ms(g_args)
        report["fold_grid"] = dict(**g_keys, **bound_keys(fold_bound(
            d1, int(fm.counts.sum()), (fm.inv_perm, fm.order, fm.excl,
                                       fm.counts), g1), library_ms=g_lib))
        del g1, g_args
    report["raster_fwd_window128"] = dict(
        max_abs_err=err, ms=b_ms, plain_ms=plain_ms, culled_share=grid_share,
        **cull_bound_keys(args, got, inp.cfg, grid_cull, n_acc))
    report["raster_bwd_window128"] = dict(
        max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms,
        culled_share=grid_share,
        **cull_bound_keys(c_args, [d1], inp.cfg, grid_cull, n_acc))
    del d1
    counters = {"raster_bwd_window128": (bwd_fn, "launches_window128"),
                "raster_fwd_window128": (fwd_fn, "launches_window128"),
                "fold_grid": (fold_pairs, "launches")}
    invert_permutation.launches = 0
    got_l, grid_ms, _ = trace_path_run(big, ro, rd, counters)
    if got_l != {k: 1 for k in counters} or invert_permutation.launches:
        raise AssertionError(f"grid trace launches {got_l}, inversions "
                             f"{invert_permutation.launches} (none: the "
                             f"caller's sort gives the inverse)")
    for k in ("raster_bwd_window128", "fold_grid"):
        launches[k] = got_l[k]
    phase("W 128 B and C", f"the grid at 100k, {n_blocks} blocks x "
          f"{seg_len} candidates, accel_overflow "
          f"{int(inp.accel_overflow)}, {n_acc:.0f} composited: B {msg}; "
          f"kernel {b_ms:.4f} ms, plain {plain_ms:.4f} ms; C {c_msg} (all "
          f"{n_blocks} blocks), max |d| {c_err:.3g}, two runs bitwise "
          f"equal, kernel {c_ms:.4f} ms, plain {c_plain_ms:.4f} ms; D on "
          f"C's rows: {fold_msg(report['fold_grid'], g_scale, g_lib)}; "
          f"{cull_msg}; k-buffer overflow passes B {b_over}, C {c_over}; trace "
          f"path launches {got_l}; "
          f"{grid_ms:.3f} ms per forward trace call (host clock)")

    # 34. normals: B's normals mode in trace (brute force) against plain,
    # and render_gut's against the port's oracle (phase 7's probe)
    ro, rd = trace_rays(small)
    nrc = RasterConfig(enable_normals=True)
    with torch.no_grad():
        inp = prepare_trace(small, ro, rd, raster_cfg=nrc)
        args = inp.args()
        got = rasterize_tiles_forward(*args)
        ref, plain_ms = timed_once(lambda: rasterize_tiles_plain(*args))
        err, msg = forward_agreement(got, ref, inp.cfg, "normals B")
        err = max(err, float((got[5] - ref[5]).abs().max()))
        b_ms = cuda_ms(lambda: rasterize_tiles_forward(*args), 5)
        rg, orc = oracle_probe(big, ut_cfg, nrc)
    bulk, raw, flip = parity_db(rg["pred_features"].cpu().numpy(),
                                orc["pred_features"].cpu().numpy())
    # the oracle's normals are float64 (on the fp32 parameters), the
    # kernel's fp32; pixels where an accept or kill decision flipped (the
    # hit counts or the features differ: a hit at min_alpha moves the
    # normals by up to 4e-3) are counted, and the rest held
    f_err = (rg["pred_features"] - orc["pred_features"]).abs().amax(-1)
    decided = ((f_err <= 0.5 / 255.0)
               & (rg["hits_count"].to(torch.int64)
                  == orc["hits_count"].to(torch.int64))[..., 0])
    n_flip = int((~decided).sum())
    o_ok, o_msg = normals_agreement(
        (rg["pred_normals"] - orc["pred_normals"]).abs().amax(-1)[decided])
    if not (o_ok and n_flip <= 0.01 * decided.numel() and flip <= 0.01
            and bulk >= 80.0):
        raise AssertionError(f"render_gut normals vs oracle: {o_msg} off "
                             f"{n_flip} decision flips, flip_frac "
                             f"{flip:.5f}")
    # phase 31's rays and records: its cull's counts
    report["raster_fwd_normals"] = dict(
        max_abs_err=err, ms=b_ms, plain_ms=plain_ms, culled_share=brute_share,
        **cull_bound_keys(args, got, inp.cfg, brute_cull, composited(ref),
                          shared_tiles=n_blocks))
    fwd_fn.launches_normals = 0
    with torch.no_grad():
        normals = trace(small, ro, rd, raster_cfg=nrc)["pred_normals"]
    torch.cuda.synchronize()
    launches["raster_fwd_normals"] = fwd_fn.launches_normals
    if launches["raster_fwd_normals"] != 1 or not bool(
            torch.isfinite(normals).all()):
        raise AssertionError("normals trace: launches "
                             f"{launches['raster_fwd_normals']}")
    phase("normals B", f"trace brute force with normals: {msg}; kernel "
          f"{b_ms:.4f} ms, plain {plain_ms:.4f} ms; render_gut vs the "
          f"oracle's float64 normals (200x200, 60k): {o_msg} off the "
          f"{n_flip} pixels of a flipped decision (features bulk "
          f"{bulk:.1f} dB, flip_frac {flip:.5f}); trace launches "
          f"{launches['raster_fwd_normals']}")

    # 35. the grid against brute force at 100k in rank order: the full
    # frame (coverage lost to max_cells), and 4 image rows (8 blocks) with
    # every cell
    ro, rd = trace_rays(big)
    with torch.no_grad():
        brute = trace(big, ro, rd, accelerate=False, _sorted=False)
        grid = trace(big, ro, rd, accelerate=True, _sorted=False)
        d_f = (grid["pred_features"] - brute["pred_features"]).abs().amax(-1)
        over = float((grid["pred_opacity"]
                      - brute["pred_opacity"]).max())
        covered = float((d_f <= 1e-4).float().mean())
        from threedgrut_tpu_torch.render.grt import build_grid
        rows = slice(TRACE_SIDE // 2 - 2, TRACE_SIDE // 2 + 2)
        o4, d4 = ro[rows].contiguous(), rd[rows].contiguous()
        accel = build_grid(big, o4.reshape(-1, 3).mean(0))
        cell_cap = int((accel.seg_start[1:-1] - accel.seg_start[:-2]).max())
        full = trace(big, o4, d4, _sorted=False, accel=accel,
                     max_cells=accel.dims ** 3, cell_cap=cell_cap)
        ref4 = trace(big, o4, d4, accelerate=False, _sorted=False)
        exact = float((full["pred_features"]
                       - ref4["pred_features"]).abs().max())
        grid_t = host_ms(lambda: trace(big, ro, rd), 3)
        brute_t = host_ms(lambda: trace(big, ro, rd, accelerate=False), 1)
    if not (exact <= 1e-5 and int(full["accel_overflow"]) == 0
            and over <= 1e-3):
        raise AssertionError(f"grid vs brute: every cell {exact:.3g}, "
                             f"overflow {int(full['accel_overflow'])}, "
                             f"opacity above brute by {over:.3g}")
    phase("grid vs brute", f"100k, rank order: with every cell (cell_cap "
          f"{cell_cap}, 8 blocks) max |d| {exact:.3g}; the full "
          f"{TRACE_SIDE}x{TRACE_SIDE} frame with the defaults "
          f"(max_cells 24, cell_cap 256): accel_overflow "
          f"{int(grid['accel_overflow'])}, {covered:.4f} of the rays within "
          f"1e-4 of brute force, opacity never above it by more than "
          f"{over:.3g}; sorted trace call (host clock): grid {grid_t:.3f} "
          f"ms, brute force {brute_t:.3f} ms")
    return report, launches


def playground_phase(dev):
    """Phase 36: the playground (playground_torch.py's engine) over the
    100k cloud with the demo primitives at 512x512, 3 bounces, 1 spp:
    ms per frame, the device's busy and idle share and kernels per frame,
    B's launches per frame; the viewer answers GET / and 3 frames.
    Returns the frame's kernel launches."""
    import io
    import urllib.request

    from PIL import Image

    from playground_torch import build_engine, frame_renderer
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles
    from threedgrut_tpu_torch.ops.cameras import orbit_camera
    from threedgrut_tpu_torch.playground.web_gui import ViewerServer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_geometry

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_train_torch import profile_steps

    model = bench_cloud(100_000, seed=0, device=dev)
    engine, center = build_engine(model, demo_primitives=True)
    _, dist = orbit_geometry(model)
    res = (TRACE_SIDE, TRACE_SIDE)
    cam = orbit_camera(0.0, 0.35, dist, center=center, resolution=res,
                       device=dev)
    frame = engine.render(cam)                    # warm-up
    rasterize_tiles.launches_window128 = 0
    t0 = time.perf_counter()
    frame = engine.render(cam)
    frame_ms = (time.perf_counter() - t0) * 1e3
    per_frame = rasterize_tiles.launches_window128
    if per_frame != engine.config.max_bounces:
        raise AssertionError(f"B launches per frame {per_frame}")
    env = engine.envmap.constant.cpu().numpy()
    moved = float(np.abs(frame - env).max(-1).mean())
    if not (frame.shape == (*res, 3) and np.isfinite(frame).all()
            and moved > 0.05):
        raise AssertionError(f"playground frame: shape {frame.shape}, "
                             f"mean distance from the envmap {moved:.3g}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.render(cam)
        times.append((time.perf_counter() - t0) * 1e3)
    wall_us, busy_us, n_device = profile_steps(lambda: engine.render(cam),
                                               2, top=10)
    server = ViewerServer(frame_renderer(engine, center, res),
                          resolution=res, port=0, host="127.0.0.1")
    url = server.start()
    try:
        page = urllib.request.urlopen(url, timeout=60).read().decode()
        sizes = []
        for az in (0.0, 2.1, 4.2):
            jpg = urllib.request.urlopen(
                f"{url}frame.jpg?az={az}&el=0.3&dist={dist:.3f}",
                timeout=120).read()
            img = Image.open(io.BytesIO(jpg))
            img.load()
            sizes.append((img.format, img.size))
    finally:
        server.stop()
    if "frame.jpg" not in page or sizes != [("JPEG", res)] * 3:
        raise AssertionError(f"viewer: page {len(page)} B, frames {sizes}")
    phase("playground", f"Engine3DGRUT over 100k with a glass icosphere and "
          f"a mirror box, {res[0]}x{res[1]}, {engine.config.max_bounces} "
          f"bounces, 1 spp: {frame_ms:.1f} ms/frame host clock (then "
          f"{', '.join(f'{t:.1f}' for t in times)}); W 128 B launches "
          f"{per_frame} per frame; 2 traced frames: wall {wall_us:.1f} "
          f"us/frame, device busy {busy_us:.1f} us/frame, idle share "
          f"{1.0 - busy_us / wall_us:.3f}, {n_device:.1f} device kernels "
          f"per frame; frame finite, {moved:.3f} mean from the envmap; "
          f"viewer: GET / and 3 frames, each a {res[0]}x{res[1]} JPEG")
    return {"raster_fwd_window128": per_frame}


# kernels F, G and H (phases 37-40): the table route's row scatter, and
# the layout ops the TPU path reaches only under its aligned_segments knob
# (G) or not at all (H); the main path launches none of them
# the table route's gradients against the D route's
TABLE_COS = 0.9999999
TABLE_TOL = 1e-5
# fill.py's stated size: 1M slots x 12 values, 100k marks
FILL_SLOTS = 1 << 20
FILL_WIDTH = 12
FILL_MARKS = 100_000


def scatter_phase(dev, v, c_args):
    """Phase 37: kernel F on the bench step's own pairs (kernel C's rows
    for phase 8's upstream gradients, summed by pair_particle): within
    1e-6 of max of the float64 plain version, bitwise repeatable and
    bitwise equal to F on the runs of the stable sort (id_runs_plain, the
    earlier set-up); ms with its set-up, of the set-up alone (the
    counting sort's three kernels) and of the kernel alone, beside
    index_add_; the kernels' resources. Returns the report entry."""
    from threedgrut_tpu_torch.ops.cuda.raster import rasterize_tiles_backward
    from threedgrut_tpu_torch.ops.cuda.scatter import (
        id_runs, id_runs_plain, kernel_attributes, scatter_accumulate_rows,
        scatter_accumulate_rows_plain, scatter_runs)

    with torch.no_grad():
        d_rec = rasterize_tiles_backward(*c_args)
        ids = v.binning.pair_particle
        n_rows = v.table.shape[0]
        args = (d_rec, ids, n_rows)
        f1 = scatter_accumulate_rows(*args)
        f2 = scatter_accumulate_rows(*args)
        f_sorted = scatter_runs(d_rec, *id_runs_plain(ids, n_rows))
        ref, plain_ms = timed_once(lambda: scatter_accumulate_rows_plain(
            *args))
        err = float((f1 - ref).abs().max())
        scale = float(ref.abs().max())
        same = bool(torch.equal(f1, f2))
        as_sorted = bool(torch.equal(f1, f_sorted))
        ms = cuda_ms(lambda: scatter_accumulate_rows(*args), 20)
        setup_ms = cuda_ms(lambda: id_runs(ids, n_rows), 20)
        setup_dev_ms = device_ms(lambda: id_runs(ids, n_rows), 20)
        runs = id_runs(ids, n_rows)
        unordered = unordered_run_share(*runs)
        body_ms = cuda_ms(lambda: scatter_runs(d_rec, *runs), 20)
        idx = ids.to(torch.int64)

        def library():
            return torch.zeros((n_rows, d_rec.shape[1]),
                               device=dev).index_add_(0, idx, d_rec)

        lib_ms = cuda_ms(library, 20)
        dev_ms = device_ms(lambda: scatter_accumulate_rows(*args), 20)
        lib_dev_ms = device_ms(library, 20)
    if not (err <= 1e-6 * scale and same and as_sorted):
        raise AssertionError(f"kernel F vs plain: max |d| {err:.3g} of "
                             f"{scale:.3g}; bitwise repeatable {same}; "
                             f"equal on the stable sort's runs {as_sorted}")
    res = kernel_attributes()
    b = bound(nbytes(d_rec, ids, f1), d_rec.numel())
    phase("kernel F", f"{d_rec.shape[0]} pairs x {d_rec.shape[1]} onto "
          f"{n_rows} rows: max |d| {err:.3g} of {scale:.3g}, two runs "
          f"bitwise equal and equal to F on the stable sort's runs; "
          f"{ms:.4f} ms with its set-up ({setup_ms:.4f} ms the counting "
          f"sort, {body_ms:.4f} ms the kernel alone), plain {plain_ms:.4f}"
          f" ms, index_add_ {lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]});"
          f" device time alone (torch.profiler) {dev_ms:.4f} ms with its "
          f"set-up ({setup_dev_ms:.4f} ms the set-up), index_add_ "
          f"{lib_dev_ms:.4f} ms; the set-up leaves {unordered:.1%} of the "
          f"rows' runs out of pair order;"
          f" registers / local / shared bytes: " + ", ".join(
              f"{k} {x['registers']}/{x['local_bytes']}/{x['shared_bytes']}"
              for k, x in res.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **bound_keys(b, library_ms=lib_ms), setup_ms=setup_ms,
                kernel_ms=body_ms, device_ms=dev_ms,
                setup_device_ms=setup_dev_ms, library_device_ms=lib_dev_ms,
                unordered_run_share=unordered, resources=res)


def unordered_run_share(perm, row_start):
    """The share of table rows whose run, as kernel F's set-up placed it,
    is not in ascending pair order (F's kernel sorts those)."""
    n_rows = row_start.shape[0] - 1
    lengths = (row_start[1:] - row_start[:-1]).to(torch.int64)
    row_of = torch.repeat_interleave(
        torch.arange(n_rows, device=perm.device), lengths)
    placed = perm[:int(row_start[-1])]
    down = (placed[1:] < placed[:-1]) & (row_of[1:] == row_of[:-1])
    return float(torch.unique(row_of[1:][down]).numel()) / max(n_rows, 1)


def table_route_phase(dev, v, b_args, c_args, fwd):
    """Phase 38: the bench step's raster forward and backward through
    rasterize_tiles_table (B, C, then F) at full width, in the 3DGUT and
    the 3DGRT setting: its image equal to the D route's (and, 3DGUT, to
    phase 4's kernel B output), its table gradient within TABLE_TOL of max
    and cosine TABLE_COS of the D route's; TRAIN_STEPS steps launch B, C
    and F (and F's set-up) once each a step and D never; host ms per step
    of both routes. Returns kernel F's and its set-up's launches in the
    3DGUT run."""
    from threedgrut_tpu_torch.ops.cuda.fold import fold_pairs
    from threedgrut_tpu_torch.ops.cuda.raster import (
        FoldMeta, rasterize_tiles, rasterize_tiles_backward,
        rasterize_tiles_table)
    from threedgrut_tpu_torch.ops.cuda.scatter import id_runs, scatter_runs
    from threedgrut_tpu_torch.render.grt import grt_raster_config

    b = v.binning
    fold = FoldMeta(b.perm, b.order, b.excl, b.counts, b.limit,
                    n_valid=b.num_pairs)
    g_feat, g_opac, g_dep = c_args[9:12]

    def step(rc, table_route):
        t = v.table.detach().clone().requires_grad_(True)
        args = (t,) + tuple(b_args[1:6]) + (rc,)
        out = (rasterize_tiles_table(*args) if table_route
               else rasterize_tiles(*args, fold))
        ((out[0] * g_feat).sum() + (out[1] * g_opac).sum()
         + (out[2] * g_dep).sum()).backward()
        return out, t.grad

    counters = {"raster_fwd": (rasterize_tiles, "launches"),
                "raster_bwd": (rasterize_tiles_backward, "launches"),
                "scatter_rows": (scatter_runs, "launches"),
                "scatter_rows_setup": (id_runs, "launches"),
                "fold": (fold_pairs, "launches")}
    msgs, launches = [], (0, 0)
    for label, rc in (("3DGUT", b_args[6]), ("3DGRT", grt_raster_config())):
        out_f, g_f = step(rc, True)
        out_d, g_d = step(rc, False)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(out_f, out_d))
        if label == "3DGUT":
            same &= all(torch.equal(out_f[i], fwd[i]) for i in range(4))
        x, y = g_f.double().flatten(), g_d.double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
        err = float((g_f - g_d).abs().max())
        scale = float(g_d.abs().max())
        if not (same and cos >= TABLE_COS and err <= TABLE_TOL * scale):
            raise AssertionError(
                f"{label} table route vs D route: images equal {same}, "
                f"cosine {cos:.9f}, max |d| {err:.3g} of {scale:.3g}")
        # the route's run: counters set to 0 after a warm-up step
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step(rc, True)
        torch.cuda.synchronize()
        table_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        want = {k: (0 if k == "fold" else TRAIN_STEPS) for k in counters}
        if got != want:
            raise AssertionError(f"{label} table route launches {got}, "
                                 f"expected {want}")
        fold_ms = host_ms(lambda: step(rc, False), TRAIN_STEPS)
        if label == "3DGUT":
            launches = got["scatter_rows"], got["scatter_rows_setup"]
        msgs.append(f"{label}: images equal, table gradient cosine "
                    f"{cos:.9f}, max |d| {err:.3g} of {scale:.3g}; "
                    f"{table_ms:.3f} ms/step (D route {fold_ms:.3f}) host "
                    f"clock over {TRAIN_STEPS} steps; launches {got}")
    phase("table route", f"rasterize_tiles_table forward and backward at "
          f"{SIDE}x{SIDE}, 100k, SH 3: " + "; ".join(msgs))
    return launches


def expand_inputs(v, s):
    """Kernel G's arguments at the bench view's two shapes of the JAX
    package (phase 39), {"pair": ..., "tile": ...}: the pair expansion
    (each depth rank's 16-float row onto its pair slots, the view's slot
    count) and the tile expansion of aligned segments
    (binning.py:_align_segments' 3 columns onto each tile's 128-aligned
    interval, over the same length)."""
    length = s.total
    with torch.no_grad():
        pair = (v.table.detach()[s.order.to(torch.int64)].contiguous(),
                s.excl, (s.excl + s.counts).to(torch.int32), length)
        # tile t's raw pairs [raw_t, raw_t + count_t) re-based to the
        # 128-aligned slot astart_t, clamped to the buffer
        raw = v.binning.tile_start.to(torch.int64)
        count = raw[1:] - raw[:-1]
        astart = torch.cat([raw.new_zeros(1), torch.cumsum(
            (count + 127) // 128 * 128, 0)]).clamp(max=length)
        vis = torch.minimum(count, length - astart[:-1])
        tile = (torch.stack([raw[:-1] - astart[:-1], raw[:-1] + vis,
                             torch.ones_like(vis)], 1).to(torch.float32),
                astart[:-1].to(torch.int32), astart[1:].to(torch.int32),
                length)
    return {"pair": pair, "tile": tile}


def fill_inputs(dev):
    """Kernel H's arguments (phase 40) at fill.py's stated size
    (FILL_SLOTS x FILL_WIDTH, FILL_MARKS marks): forward_fill's (vals,
    marked), and segmented_fill_rows's (row_vals, slots, length) with the
    marks' slots, 1,000 of them shared by two rows and 100 out of range."""
    gen = torch.Generator(device=dev).manual_seed(40)
    n, d = FILL_SLOTS, FILL_WIDTH
    with torch.no_grad():
        vals = torch.randn((n, d), generator=gen, device=dev)
        pos = torch.randperm(n, generator=gen, device=dev)[:FILL_MARKS]
        marked = torch.zeros(n, dtype=torch.bool, device=dev)
        marked[pos] = True
        row_vals = torch.randn((FILL_MARKS, d), generator=gen, device=dev)
        slots = pos.to(torch.int32)
        slots[:1000] = slots[1000:2000]          # shared slots
        slots[-100:] += n                        # dropped
    return (vals, marked), (row_vals, slots, n)


def expand_phase(dev, v, s):
    """Phase 39: kernel G equal to its plain version and to a
    searchsorted + index_select version at expand_inputs' two shapes; ms
    by CUDA events and device time beside both. Returns ({report name:
    entry}, {report name: launches}), the pair expansion under
    expand_rows and the tile expansion under expand_rows_tiles, each
    launching once in its own call."""
    from threedgrut_tpu_torch.ops.cuda.expand import (
        expand_sorted_rows, expand_sorted_rows_plain)

    inputs = expand_inputs(v, s)
    length = s.total
    names = {"pair": "expand_rows", "tile": "expand_rows_tiles"}
    with torch.no_grad():
        slot = torch.arange(length, dtype=torch.int32, device=dev)

        def library(rows, starts, ends, n):
            src = torch.searchsorted(starts, slot, right=True) - 1
            ok = (src >= 0) & (slot < ends[src.clamp(min=0)])
            padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
            return padded.index_select(
                0, torch.where(ok, src, rows.shape[0]))

        msgs, entries, launches = [], {}, {}
        for label, args in inputs.items():
            expand_sorted_rows.launches = 0
            got = expand_sorted_rows(*args)
            torch.cuda.synchronize()
            launches[names[label]] = expand_sorted_rows.launches
            ref = expand_sorted_rows_plain(*args)
            if not (torch.equal(got, ref) and torch.equal(got,
                                                          library(*args))):
                raise AssertionError(f"kernel G ({label} expansion) differs "
                                     f"from plain at "
                                     f"{int((got != ref).sum())} values")
            ms = cuda_ms(lambda: expand_sorted_rows(*args), 20)
            dev_ms = device_ms(lambda: expand_sorted_rows(*args), 20)
            plain_ms = cuda_ms(lambda: expand_sorted_rows_plain(*args), 5)
            lib_ms = cuda_ms(lambda: library(*args), 20)
            # the bounds, the rows of non-empty intervals, the output
            rows, starts, ends = args[:3]
            b = bound(nbytes(starts, ends, got)
                      + int((ends > starts).sum()) * rows.shape[1]
                      * rows.element_size(), 0)
            msgs.append(f"{label}s: {rows.shape[0]} intervals x "
                        f"{rows.shape[1]} onto {length} slots equal to "
                        f"plain; {ms:.4f} ms (device {dev_ms:.4f}), plain "
                        f"{plain_ms:.4f} ms, searchsorted + index_select "
                        f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
                        f"launches {launches[names[label]]}")
            entries[names[label]] = dict(
                max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                **bound_keys(b, library_ms=lib_ms))
    phase("kernel G", "; ".join(msgs))
    return entries, launches


def fill_phase(dev):
    """Phase 40: kernel H equal to its plain versions at fill_inputs'
    size: forward_fill (also equal to torch.cummax + a gather), and
    segmented_fill_rows with shared and dropped slots; ms by CUDA events
    and device time. Returns ({report name: entry}, {report name:
    launches}), forward_fill under fill and segmented_fill_rows under
    fill_segmented, each launching once in its own call."""
    from threedgrut_tpu_torch.ops.cuda.fill import (
        forward_fill, forward_fill_plain, segmented_fill_rows,
        segmented_fill_rows_plain)

    ff, rows = fill_inputs(dev)
    (vals, marked), (row_vals, slots, n) = ff, rows
    d = vals.shape[1]
    with torch.no_grad():
        launches = {}
        for name, fn, args in (("fill", forward_fill, ff),
                               ("fill_segmented", segmented_fill_rows, rows)):
            forward_fill.launches = 0
            fn(*args)
            torch.cuda.synchronize()
            launches[name] = forward_fill.launches
        got, got_rows = forward_fill(*ff), segmented_fill_rows(*rows)
        torch.cuda.synchronize()
        if not (torch.equal(got, forward_fill_plain(*ff))
                and torch.equal(got_rows, segmented_fill_rows_plain(*rows))):
            raise AssertionError("kernel H differs from its plain versions")
        last_pos = torch.where(marked, torch.arange(n, device=dev),
                               torch.full((n,), -1, device=dev))
        padded = torch.cat([vals, vals.new_zeros((1, d))])

        def library():
            last = torch.cummax(last_pos, 0).values
            return padded.index_select(0, torch.where(last >= 0, last, n))

        if not torch.equal(got, library()):
            raise AssertionError("kernel H differs from cummax + gather")
        ms = cuda_ms(lambda: forward_fill(*ff), 20)
        dev_ms = device_ms(lambda: forward_fill(*ff), 20)
        plain_ms = cuda_ms(lambda: forward_fill_plain(*ff), 5)
        lib_ms = cuda_ms(library, 20)
        rows_ms = cuda_ms(lambda: segmented_fill_rows(*rows), 20)
        rows_dev_ms = device_ms(lambda: segmented_fill_rows(*rows), 20)
        rows_plain_ms = cuda_ms(lambda: segmented_fill_rows_plain(*rows), 5)
        # the marks, each marked slot's row, the output
        b = bound(nbytes(marked, got)
                  + int(marked.sum()) * d * vals.element_size(), 0)
        # the slots, the row that wins each slot in range, the output
        kept = int(torch.unique(slots[(slots >= 0) & (slots < n)]).numel())
        b_rows = bound(nbytes(slots, got_rows)
                       + kept * d * row_vals.element_size(), 0)
    phase("kernel H", f"forward_fill {n} x {d}, {FILL_MARKS} marks: equal "
          f"to plain and to cummax + gather; {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, cummax + gather "
          f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), launches "
          f"{launches['fill']}; segmented_fill_rows of {FILL_MARKS} rows "
          f"(1000 slots shared, 100 dropped; {kept} slots kept): equal to "
          f"plain, {rows_ms:.4f} ms (device {rows_dev_ms:.4f}), plain "
          f"{rows_plain_ms:.4f} ms, bound {b_rows[0]:.4f} ms ({b_rows[1]}),"
          f" launches {launches['fill_segmented']}")
    return {"fill": dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms,
                         **bound_keys(b, library_ms=lib_ms)),
            "fill_segmented": dict(max_abs_err=0.0, ms=rows_ms,
                                   device_ms=rows_dev_ms,
                                   plain_ms=rows_plain_ms,
                                   **bound_keys(b_rows))}, launches


# report name -> "<wrapper>.<counter>" of the kernels the
# evaluation path's CLIs launch (their "launches:" line,
# ops/cuda/__init__.py:launch_counts)
EVAL_COUNTERS = {
    "bin_decode": "expand_decode_pairs.launches",
    "raster_fwd": "rasterize_tiles.launches",
    "raster_bwd": "rasterize_tiles_backward.launches",
    "fold": "fold_pairs.launches",
    "fold_invert": "invert_permutation.launches",
    "wmax": "pair_weight_max.launches",
    "raster_fwd_nht": "rasterize_tiles.launches_nht",
    "raster_bwd_nht": "rasterize_tiles_backward.launches_nht",
    "fold_64": "fold_pairs.launches_wide",
}
EVAL_SIDE, EVAL_TRAIN, EVAL_VAL = 800, 4, 2
EVAL_STEPS, EVAL_VALIDATE_STEPS = 200, 30
# render.py's metrics.json keys (render.py:127-145)
EVAL_KEYS = ("psnr", "ssim", "psnr_cc", "ssim_cc", "lpips", "best_frame",
             "worst_frame", "per_frame")
LPIPS_TOL = 1e-4


def run_cli(label, args, timeout=600):
    """One of the port's CLIs in its own process from the repository root:
    its standard output and the launch counts of its last "launches:"
    line; raises on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"{label}: exit {res.returncode}\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("launches:")]
    if not lines:
        raise AssertionError(f"{label}: no launches line\n"
                             f"{res.stdout[-2000:]}")
    got = json.loads(lines[-1].split(":", 1)[1])
    counts = {k: got.get(c, 0) for k, c in EVAL_COUNTERS.items()}
    return res.stdout, counts, time.perf_counter() - t0


def eval_phase(dev):
    """Phase 41: generate, train, evaluate and validate through the
    port's CLIs on the card. Returns the launches by kernel and entry
    point."""
    import shutil

    from threedgrut_tpu_torch.utils import lpips as lpips_mod

    root = os.path.join(REPO, "build", "smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    launches, secs, msgs = {}, {}, []

    def check(label, got, want):
        bad = {k: (got[k], v) for k, v in want.items()
               if not (got[k] >= v[0] if isinstance(v, tuple)
                       else got[k] == v)}
        if bad:
            raise AssertionError(f"{label}: launches (got, wanted) {bad}")

    n_views = EVAL_TRAIN + 2 * EVAL_VAL
    out, launches["gen"], secs["gen"] = run_cli("generator", [
        os.path.join("scripts", "gen_synthetic_scene_torch.py"), "--out",
        data, "--side", str(EVAL_SIDE), "--n-train", str(EVAL_TRAIN),
        "--n-val", str(EVAL_VAL)])
    slots = [int(ln.split(": ", 1)[1].split()[0]) for ln in
             out.splitlines() if "pair slots before the tile cull" in ln]
    if len(slots) != n_views:
        raise AssertionError(f"generator: {len(slots)} pair lines for "
                             f"{n_views} views\n{out[-2000:]}")
    check("generator", launches["gen"],
          {"bin_decode": n_views, "raster_fwd": n_views})
    msgs.append(f"{n_views} views {EVAL_SIDE}x{EVAL_SIDE} generated in "
                f"{secs['gen']:.1f} s, pair slots per view {slots}")
    metrics = {}
    for steps in (0, EVAL_STEPS):
        name = f"smoke{steps}"
        _, launches[f"train{steps}"], secs[f"train{steps}"] = run_cli(
            f"train_torch.py {steps} steps", [
                "train_torch.py", "--config-name",
                "apps/nerf_synthetic_3dgut", f"path={data}",
                f"n_iterations={steps}", f"out_dir={root}",
                f"experiment_name={name}"])
        eval_dir = os.path.join(root, name, "eval")
        _, launches[f"render{steps}"], secs[f"render{steps}"] = run_cli(
            f"render_torch.py ({steps} steps)", [
                "render_torch.py", "--checkpoint",
                os.path.join(root, name, "ckpt_last.npz"), "--path", data,
                "--out-dir", eval_dir])
        check(f"render_torch.py ({steps} steps)", launches[f"render{steps}"],
              {"bin_decode": EVAL_VAL, "raster_fwd": EVAL_VAL})
        with open(os.path.join(eval_dir, "metrics.json")) as f:
            metrics[steps] = json.load(f)
        if tuple(metrics[steps]) != EVAL_KEYS or not all(
                math.isfinite(metrics[steps][k])
                for k in ("psnr", "ssim", "psnr_cc", "ssim_cc")):
            raise AssertionError(f"render_torch.py: metrics.json "
                                 f"{metrics[steps]}")
    check("train_torch.py", launches[f"train{EVAL_STEPS}"],
          {k: (EVAL_STEPS,) for k in ("bin_decode", "raster_fwd",
                                       "raster_bwd", "fold",
                                       "fold_invert")})
    if not metrics[EVAL_STEPS]["psnr"] > metrics[0]["psnr"]:
        raise AssertionError(f"test psnr after {EVAL_STEPS} steps "
                             f"{metrics[EVAL_STEPS]['psnr']} not above the "
                             f"0-step checkpoint's {metrics[0]['psnr']}")
    msgs.append(
        f"train_torch.py 0 and {EVAL_STEPS} steps exit 0 in "
        f"{secs['train0']:.1f} and {secs[f'train{EVAL_STEPS}']:.1f} s; "
        f"render_torch.py on {EVAL_VAL} test views in "
        f"{secs['render0']:.1f} and {secs[f'render{EVAL_STEPS}']:.1f} s: "
        + ", ".join(f"{k} {metrics[0][k]:.4f} -> "
                    f"{metrics[EVAL_STEPS][k]:.4f}"
                    for k in ("psnr", "ssim", "psnr_cc", "ssim_cc"))
        + f", lpips {metrics[EVAL_STEPS]['lpips']!r}")
    report = os.path.join(root, "report.md")
    _, launches["validate"], secs["validate"] = run_cli("validate_torch.py", [
        "validate_torch.py", "--iterations", str(EVAL_VALIDATE_STEPS),
        "--out", report])
    with open(report) as f:
        rows = [ln for ln in f.read().splitlines() if ln.startswith("| 3D")]
    if len(rows) != 3:
        raise AssertionError(f"validate_torch.py: rows {rows}")
    check("validate_torch.py", launches["validate"], {
        "raster_fwd": (2 * EVAL_VALIDATE_STEPS,),
        "raster_bwd": 2 * EVAL_VALIDATE_STEPS,
        "raster_fwd_nht": (EVAL_VALIDATE_STEPS,),
        "raster_bwd_nht": EVAL_VALIDATE_STEPS,
        "fold_64": EVAL_VALIDATE_STEPS})
    msgs.append(f"validate_torch.py --iterations {EVAL_VALIDATE_STEPS} in "
                f"{secs['validate']:.1f} s: " + "; ".join(rows))
    # LPIPS on the card against the same call on the CPU
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (1, 3, 128, 128)).astype(
        np.float32)) for _ in range(2))
    on_card = float(lpips_mod.lpips(lpips_mod.random_params(0, dev),
                                    a.to(dev), b.to(dev)))
    on_cpu = float(lpips_mod.lpips(lpips_mod.random_params(0), a, b))
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    if not rel <= LPIPS_TOL:
        raise AssertionError(f"LPIPS on the card {on_card} against the CPU "
                             f"{on_cpu}: rel {rel:.3g}")
    msgs.append(f"LPIPS random_params(0) 1x3x128x128: card {on_card:.7f}, "
                f"CPU {on_cpu:.7f}, rel {rel:.3g}")
    by_kernel = {k: {e: c[k] for e, c in launches.items() if c[k]}
                 for k in EVAL_COUNTERS}
    msgs.append(f"launches {by_kernel}")
    phase("evaluation path", "; ".join(msgs))
    shutil.rmtree(root, ignore_errors=True)
    return by_kernel


# phases 42-43: the cuSFM path at the published width of
# apps/cusfm_3dgut_mcmc (MCMC capacity 2,300,000, SH 3, white background,
# PPISP with the controller) from a 1,000,000-point fused cloud on
# 1920x1080 pinhole views
CUSFM_CONFIG = "apps/cusfm_3dgut_mcmc"
CUSFM_RES = (1920, 1080)
CUSFM_POINTS = 1_000_000
CUSFM_STEP_VIEWS = 4
CUSFM_VIEWS = 12
CUSFM_STEPS, CUSFM_DISTILL, CUSFM_SHORT = 200, 300, 10
# the exposure offsets (stops) the CLI's capture is scaled by, and the
# least Pearson correlation of the learned per-frame exposures with them
# (written into PERF.md before the first run)
CUSFM_OFFSETS = 0.5
CUSFM_EXPOSURE_CORR = 0.8
ISP_TOL = 1e-5
# elements of the 1920x1080x3 image gradient allowed past ISP_TOL against
# float64: a value within fp32 rounding of a clamp (0, 1) or of the CRF's
# centre takes the other side in float64, where the slope jumps
ISP_FLIP_CAP = 64
# the CRFs the trainer starts from and trains into ("init", "trained";
# isp_inputs) leave a few hundred image-gradient elements past ISP_TOL of
# float64 in any fp32 version: there the card is held to be no worse
# than the same chain in fp32 on the CPU. At each level, the card's
# elements past it are at most ISP_FP32_SLACK times the CPU's plus
# ISP_FLIP_CAP; its largest errors at most twice the CPU's (or within
# ISP_TOL); and the CPU's own elements past ISP_TOL at most ISP_ILL_CAP
ISP_FP32_LEVELS = (1e-5, 1e-4, 1e-3)
ISP_FP32_SLACK = 1.25
ISP_ILL_CAP = 2000
# report name -> the counter of the wrappers the cuSFM path launches
CUSFM_KERNELS = ("bin_decode", "raster_fwd", "raster_bwd", "fold",
                 "fold_invert", "wmax")


def isp_inputs(crf="steep", seed=42):
    """The ISP check's inputs at 1920x1080: tables away from the identity
    (exposures of -0.5, 0.5 and 0.25 stops, colour latents, vignetting,
    responsivity) and an image up to 1.6, with the CRF
    - "steep": toe and shoulder drawn at 2.07 or more, gamma at 1.34 or
      more, where x^p near 0 and (1 - x)^p near 1 keep the relative
      precision of x and 1 - x, and every fp32 version holds 1e-5 of
      float64;
    - "init": raw 0 (toe and shoulder 0.99, gamma 0.79), where the
      trainer starts (init_ppisp_params);
    - "trained": raw toe and shoulder in [-0.5, 1] (0.77-1.61), gamma in
      [-0.5, 0.5], as training moves them.
    Under "init" and "trained" an exponent under 1 sends a pre-CRF value
    near 0 a gradient that grows as it shrinks, and a blue value near 0
    is the homography's intensity less red and green: a few hundred
    elements lose up to a few percent to fp32 rounding in any fp32
    version, the CPU's too (isp_fp32_check)."""
    rng = np.random.default_rng(seed)
    w, h = CUSFM_RES
    steep = np.concatenate([rng.uniform(1.6, 2.2, (1, 3, 2)),
                            rng.uniform(0.6, 1.2, (1, 3, 1)),
                            rng.normal(size=(1, 3, 1)) * 0.3], axis=-1)
    params = {
        "exposure": np.array([-0.5, 0.5, 0.25]),
        "color_latents": rng.normal(size=(3, 8)) * 0.3,
        "responsivity": np.array([0.1]),
        "vig_center": rng.normal(size=(1, 3, 2)) * 0.05,
        "vig_alpha": rng.normal(size=(1, 3, 3)) * 0.1 - 0.2}
    rgb = rng.uniform(0.0, 1.6, (h, w, 3)).astype(np.float32)
    weight = rng.normal(size=3).astype(np.float32)
    params["crf"] = {"steep": steep, "init": np.zeros((1, 3, 4)),
                     "trained": np.concatenate(
                         [rng.uniform(-0.5, 1.0, (1, 3, 2)),
                          rng.uniform(-0.5, 0.5, (1, 3, 1)),
                          rng.normal(size=(1, 3, 1)) * 0.3], axis=-1)}[crf]
    return {k: v.astype(np.float32) for k, v in params.items()}, rgb, weight


def isp_fp32_check(dev, crf):
    """The ISP's forward and backward at 1920x1080 with the CRF ``crf``
    of isp_inputs on the card, held to the float64 chain on the CPU no
    worse than the fp32 chain on the CPU is (ISP_FP32_LEVELS). Returns
    the report's words."""
    from threedgrut_tpu_torch.models.ppisp import apply_ppisp_full

    params, rgb, weight = isp_inputs(crf)

    def run(device, dtype):
        p = {k: torch.tensor(v, dtype=dtype, device=device,
                             requires_grad=True) for k, v in params.items()}
        x = torch.tensor(rgb, dtype=dtype, device=device, requires_grad=True)
        out = apply_ppisp_full(p, x, 0, 1)
        (out * torch.tensor(weight, dtype=dtype, device=device)
         ).sum().backward()
        grads = {**{k: p[k].grad for k in params}, "image": x.grad}
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            raise AssertionError(f"ISP ({crf} CRF) on {device} {dtype}: "
                                 "a gradient is not finite")
        return {"forward": out.detach(), **grads}

    ref = run("cpu", torch.float64)

    def errors(got):
        """forward |d|, each table's max-normalised |d|, and the image
        gradient's max-normalised |d| by element."""
        d = {k: (v.cpu().double() - ref[k]).abs() for k, v in got.items()}
        d = {k: v if k == "forward" else v / ref[k].abs().max()
             for k, v in d.items()}
        return d

    card, cpu = errors(run(dev, torch.float32)), errors(run("cpu",
                                                            torch.float32))
    bad = [k for k in card
           if float(card[k].max()) > max(ISP_TOL, 2 * float(cpu[k].max()))]
    counts = [(t, int((card["image"] > t).sum()),
               int((cpu["image"] > t).sum())) for t in ISP_FP32_LEVELS]
    bad += [f"image past {t}" for t, n, n_cpu in counts
            if n > ISP_FP32_SLACK * n_cpu + ISP_FLIP_CAP]
    if counts[0][2] > ISP_ILL_CAP:
        bad.append(f"the CPU's fp32 image gradient past {ISP_TOL}")
    def worst(d, keys):
        return max(float(d[k].max()) for k in keys)

    words = (f"{crf} CRF: forward |d| {worst(card, ['forward']):.3g} (CPU "
             f"fp32 {worst(cpu, ['forward']):.3g}), tables' gradients up "
             f"to {worst(card, params):.3g} (CPU fp32 "
             f"{worst(cpu, params):.3g}), image gradient up to "
             f"{worst(card, ['image']):.3g} (CPU fp32 "
             f"{worst(cpu, ['image']):.3g}), elements past "
             + ", ".join(f"{t}: {n} (CPU fp32 {n_cpu})"
                         for t, n, n_cpu in counts))
    if bad:
        raise AssertionError(f"ISP vs float64 worse than fp32 on the CPU "
                             f"in {bad}: {words}")
    return words


def isp_phase(dev):
    """Phase 42a: the ISP at 1920x1080 on the card, forward and backward,
    against its float64 version on the CPU; the controller on the
    distillation's 480x270 input likewise; their times, and the ISP's
    kernels a forward and backward."""
    import copy

    from threedgrut_tpu_torch.models.ppisp import (PPISPControllerCNN,
                                                   apply_ppisp_full)

    params, rgb, weight = isp_inputs()

    def leaves(device, dtype, grad=True):
        p = {k: torch.tensor(v, dtype=dtype, device=device,
                             requires_grad=grad) for k, v in params.items()}
        return p, torch.tensor(rgb, dtype=dtype, device=device,
                               requires_grad=grad)

    def forward_backward(p, x):
        out = apply_ppisp_full(p, x, 0, 1)
        (out * torch.tensor(weight, dtype=x.dtype, device=x.device)
         ).sum().backward()
        return out.detach()

    p, x = leaves(dev, torch.float32)
    out = forward_backward(p, x)
    p64, x64 = leaves("cpu", torch.float64)
    ref = forward_backward(p64, x64)
    fwd_err = float((out.cpu().double() - ref).abs().max())
    errs = {k: float((p[k].grad.cpu().double() - p64[k].grad).abs().max()
                     / p64[k].grad.abs().max()) for k in params}
    d_img = (x.grad.cpu().double() - x64.grad).abs()
    scale = float(x64.grad.abs().max())
    n_over = int((d_img > ISP_TOL * scale).sum())
    img_err = float(d_img.max()) / scale
    ok = (fwd_err <= ISP_TOL and max(errs.values()) <= ISP_TOL
          and n_over <= ISP_FLIP_CAP and all(
              bool(torch.isfinite(g).all())
              for g in [x.grad] + [p[k].grad for k in params]))
    if not ok:
        raise AssertionError(
            f"ISP vs float64: forward {fwd_err:.3g}, tables {errs}, image "
            f"gradient {n_over} elements past {ISP_TOL} (max {img_err:.3g})")
    pf, xf = leaves(dev, torch.float32, grad=False)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: apply_ppisp_full(pf, xf, 0, 1), 20)
    pb, xb = leaves(dev, torch.float32)
    fb_ms = cuda_ms(lambda: forward_backward(pb, xb), 10)
    (counts, us), _ = _profiled_calls(lambda: forward_backward(pb, xb), 3)
    launches, dev_ms = sum(counts.values()), sum(us.values()) / 1e3
    conditioned = [isp_fp32_check(dev, crf) for crf in ("init", "trained")]

    # the controller on the distillation's input: every 4th pixel
    ctrl = PPISPControllerCNN(seed=42, device=dev)
    ctrl64 = copy.deepcopy(ctrl).double().cpu()
    img = rgb[::4, ::4]
    with torch.no_grad():
        e, c = ctrl.predict(torch.tensor(img, device=dev), 0.0)
        e64, c64 = ctrl64.predict(torch.tensor(img, dtype=torch.float64),
                                  0.0)
        ctrl_ms = cuda_ms(lambda: ctrl.predict(
            torch.tensor(img, device=dev), 0.0), 20)
    c_err = max(abs(float(e) - float(e64)),
                float((c.cpu().double() - c64).abs().max()))
    if not c_err <= ISP_TOL:
        raise AssertionError(f"controller vs float64: {c_err:.3g}")
    w, h = CUSFM_RES
    phase("ISP and controller", f"{w}x{h}, steep CRF: forward |d| "
          f"{fwd_err:.3g} of "
          f"float64, tables' gradients "
          + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
          + f" (max-normalised), image gradient {img_err:.3g} with "
          f"{n_over} of {d_img.numel()} elements past {ISP_TOL}; forward "
          f"{fwd_ms:.4f} ms, forward + backward {fb_ms:.4f} ms by events "
          f"(device {dev_ms:.4f} ms, {launches} kernels); controller on "
          f"{img.shape[1]}x{img.shape[0]} |d| {c_err:.3g} of float64, "
          f"{ctrl_ms:.4f} ms; " + "; ".join(conditioned))


def cusfm_counters():
    """The wrappers the cuSFM path launches, by report name."""
    from threedgrut_tpu_torch.ops.cuda.expand import expand_decode_pairs
    from threedgrut_tpu_torch.ops.cuda.fold import (fold_pairs,
                                                    invert_permutation)
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward)
    from threedgrut_tpu_torch.ops.cuda.wmax import pair_weight_max

    return dict(zip(CUSFM_KERNELS, (
        expand_decode_pairs, rasterize_tiles, rasterize_tiles_backward,
        fold_pairs, invert_permutation, pair_weight_max)))


def cusfm_step_phase(dev, teacher, fused):
    """Phase 42b: the full-width apps/cusfm_3dgut_mcmc step through
    train_torch.py's make_model (the fused cloud read back from its PLY)
    and the Trainer, 20 timed steps with PPISP on and off: A-D and D's
    inversion launch once a step, E never; ms/step, device busy, idle
    share and device kernels a step. Returns the launches by setting."""
    import dataclasses

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_train_torch import profile_steps, time_steps
    from threedgrut_tpu_torch.config.loader import load_config
    from threedgrut_tpu_torch.models.gaussians import default_capacity_for
    from threedgrut_tpu_torch.synthetic import teacher_dataset
    from threedgrut_tpu_torch.train.trainer import Trainer
    from train_torch import make_model, trainer_config

    ds = teacher_dataset(teacher, n_views=CUSFM_STEP_VIEWS,
                         resolution=CUSFM_RES)
    conf = load_config(CUSFM_CONFIG, overrides=[
        "path=none", f"initialization.fused_point_cloud_path={fused}"])
    t0 = time.perf_counter()
    model = make_model(conf, ds, dev)
    init_s = time.perf_counter() - t0
    cap = default_capacity_for(conf.strategy.add.max_n_gaussians)
    if (model.n_active, model.capacity) != (CUSFM_POINTS, cap):
        raise AssertionError(f"cuSFM model: n_active {model.n_active}, "
                             f"capacity {model.capacity}")
    tconf = trainer_config(conf)
    counters = cusfm_counters()
    kernels, launches, msgs = {}, {}, []
    for label, post in (("ppisp", "ppisp"), ("no_ppisp", None)):
        trainer = Trainer(dataclasses.replace(tconf, post_processing=post),
                          ds, model)
        frames = iter(range(10 ** 6))

        def step():
            i = next(frames) % len(ds)
            return trainer.train_iteration(ds[i], frame_idx=i)["total"]

        time_steps(step, 3)                       # warm-up
        for fn in counters.values():
            fn.launches = 0
        ms, losses = time_steps(step, TRAIN_STEPS)
        got = {k: fn.launches for k, fn in counters.items()}
        want = {k: 0 if k == "wmax" else TRAIN_STEPS for k in got}
        if got != want or not all(np.isfinite(losses)):
            raise AssertionError(f"cuSFM step ({label}): launches {got}, "
                                 f"wanted {want}; losses {losses[:3]}")
        wall_us, busy_us, n_dev = profile_steps(step, 5, top=10)
        kernels[label] = n_dev
        launches[label] = got
        msgs.append(f"PPISP {'on' if post else 'off'}: {ms:.3f} ms/step "
                    f"({1e3 / ms:.2f} it/s) host clock over {TRAIN_STEPS} "
                    f"steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}; 5 "
                    f"traced: wall {wall_us:.1f} us/step, device busy "
                    f"{busy_us:.1f} us/step, idle share "
                    f"{1.0 - busy_us / wall_us:.3f}, {n_dev:.1f} device "
                    f"kernels a step")
    w, h = CUSFM_RES
    phase("cuSFM step", f"{CUSFM_CONFIG} at {w}x{h}, {model.n_active} "
          f"Gaussians from the fused cloud (capacity {model.capacity}; "
          f"make_model {init_s:.1f} s), SH 3: " + "; ".join(msgs)
          + f"; launches {launches['ppisp']} a {TRAIN_STEPS}-step window "
          f"each way; the ISP adds "
          f"{kernels['ppisp'] - kernels['no_ppisp']:.1f} device kernels a "
          "step")
    return launches


def cusfm_cli_phase(dev, teacher, fused):
    """Phase 43: train_torch.py --config-name apps/cusfm_3dgut_mcmc on a
    generated 1920x1080 COLMAP capture of 12 views, each scaled by a known
    exposure offset, from the fused cloud: 200 steps, the controller's
    distillation (its loss falls), export_ply; the learned exposures
    against the offsets; 10 steps each from the checkpoint
    (initialization.method=checkpoint) and from the export (import_ply);
    apps/colmap_3dgut with gsplat's normalisation and factor-2 cache, 30
    steps; render_torch.py on the PPISP checkpoint. Returns the launches
    by kernel and entry point."""
    import re
    import shutil

    from threedgrut_tpu_torch.synthetic import (teacher_dataset,
                                                write_colmap_scene)

    root = os.path.join(REPO, "build", "smoke_cusfm_cli")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    views = teacher_dataset(teacher, n_views=CUSFM_VIEWS,
                            resolution=CUSFM_RES)
    offsets = np.random.default_rng(43).permutation(
        np.linspace(-CUSFM_OFFSETS, CUSFM_OFFSETS, CUSFM_VIEWS))
    for view, e in zip(views.views, offsets):
        view.rgb_gt = torch.clamp(view.rgb_gt * float(2.0 ** e), 0.0, 1.0)
    write_colmap_scene(data, views, teacher, n_points=20000)
    gen_s = time.perf_counter() - t0
    launches, secs, msgs = {}, {}, []

    def run(label, args, **want):
        out, launches[label], secs[label] = run_cli(label, args, timeout=900)
        got = {k: launches[label][k] for k in want}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, wanted {want}")
        return out

    ckpt = os.path.join(root, "cusfm", "ckpt_last.npz")
    export = os.path.join(root, "cusfm", "export_last.ply")
    common = [f"path={data}", f"out_dir={root}", "log_frequency=0.5"]
    n_train = CUSFM_VIEWS - len(range(0, CUSFM_VIEWS, 8))
    renders = CUSFM_STEPS + n_train + 2      # steps, distillation, 2 val
    out = run("train", [
        "train_torch.py", "--config-name", CUSFM_CONFIG, *common,
        f"initialization.fused_point_cloud_path={fused}",
        f"n_iterations={CUSFM_STEPS}",
        f"post_processing.n_distillation_steps={CUSFM_DISTILL}",
        "export_ply.enabled=true", "experiment_name=cusfm"],
        bin_decode=renders, raster_fwd=renders, raster_bwd=CUSFM_STEPS,
        fold=CUSFM_STEPS, fold_invert=CUSFM_STEPS, wmax=0)
    found = re.search(r"controller distillation loss: (\S+) \(first step "
                      r"(\S+); (\S+) s\)", out)
    last, first, distill_s = (float(found.group(i)) for i in (1, 2, 3))
    if not last < first:
        raise AssertionError(f"distillation loss {first} -> {last}")
    with np.load(ckpt) as f:
        exposure = f["params/ppisp//exposure"]
        n_active = int(f["n_active"])
    train_idx = [i for i in range(CUSFM_VIEWS) if i % 8]
    corr = float(np.corrcoef(exposure, offsets[train_idx])[0, 1])
    if not corr >= CUSFM_EXPOSURE_CORR:
        raise AssertionError(f"learned exposures {exposure} against the "
                             f"offsets {offsets[train_idx]}: correlation "
                             f"{corr:.4f} < {CUSFM_EXPOSURE_CORR}")
    final = [ln for ln in out.splitlines() if ln.startswith("final:")]
    msgs.append(f"{CUSFM_VIEWS} views written in {gen_s:.1f} s (exposure "
                f"offsets {np.round(offsets, 3).tolist()}); train_torch.py "
                f"{CUSFM_STEPS} steps and a {CUSFM_DISTILL}-step "
                f"distillation in {secs['train']:.1f} s: distillation loss "
                f"{first:.6g} -> {last:.6g} in {distill_s:.2f} s, learned "
                f"exposures "
                f"{np.round(exposure, 4).tolist()}, correlation with the "
                f"offsets {corr:.4f} (>= {CUSFM_EXPOSURE_CORR}); "
                f"n_active {n_active}; {final[-1] if final else ''}")
    short = [f"n_iterations={CUSFM_SHORT}", "test_last=false",
             f"post_processing.n_distillation_steps={CUSFM_SHORT}"]
    each = CUSFM_SHORT + n_train
    for label, init in (("from_checkpoint", [
            "initialization.method=checkpoint",
            f"initialization.path={ckpt}"]), ("import_ply", [
            "import_ply.enabled=true", f"import_ply.path={export}"])):
        run(label, ["train_torch.py", "--config-name", CUSFM_CONFIG,
                    *common, *init, *short, f"experiment_name={label}"],
            bin_decode=each, raster_fwd=each, raster_bwd=CUSFM_SHORT,
            wmax=0)
    msgs.append(f"{CUSFM_SHORT} steps from the checkpoint in "
                f"{secs['from_checkpoint']:.1f} s and from the export in "
                f"{secs['import_ply']:.1f} s")
    run("gsplat", ["train_torch.py", "--config-name", "apps/colmap_3dgut",
                   *common, "dataset.gsplat_normalize=true",
                   "dataset.gsplat_image_downscale=true",
                   "dataset.downsample_factor=2", "n_iterations=30",
                   "test_last=false", "experiment_name=gsplat"],
        raster_bwd=30, fold=30)
    cache = sorted(os.listdir(os.path.join(data, "images_2_png")))
    if len(cache) != CUSFM_VIEWS:
        raise AssertionError(f"gsplat cache: {cache}")
    msgs.append(f"apps/colmap_3dgut with gsplat_normalize and the factor-2 "
                f"cache ({len(cache)} PNGs) 30 steps in "
                f"{secs['gsplat']:.1f} s")
    eval_dir = os.path.join(root, "eval")
    run("render", ["render_torch.py", "--checkpoint", ckpt, "--path", data,
                   "--out-dir", eval_dir], bin_decode=2, raster_fwd=2)
    with open(os.path.join(eval_dir, "metrics.json")) as f:
        metrics = json.load(f)
    if not all(math.isfinite(metrics[k]) for k in ("psnr", "ssim")):
        raise AssertionError(f"render_torch.py: {metrics}")
    n_test = len(metrics["per_frame"])
    msgs.append(f"render_torch.py on the PPISP checkpoint ({n_test} test "
                f"views) in {secs['render']:.1f} s: psnr "
                f"{metrics['psnr']:.4f}, ssim {metrics['ssim']:.4f}")
    phase("cuSFM CLI", "; ".join(msgs))
    shutil.rmtree(root, ignore_errors=True)
    return {k: {e: c[k] for e, c in launches.items() if c[k]}
            for k in CUSFM_KERNELS}


def cusfm_phases(dev):
    """Phases 42-43 on one teacher and one fused cloud. Returns the
    launches of the full-width step by setting and of the CLIs by
    kernel."""
    import shutil

    from threedgrut_tpu_torch.synthetic import build_teacher, write_fused_cloud

    isp_phase(dev)
    root = os.path.join(REPO, "build", "smoke_cusfm")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    teacher = build_teacher(60000, seed=0, device=dev)
    fused = write_fused_cloud(os.path.join(root, "fused.ply"), teacher,
                              CUSFM_POINTS)
    step_launches = cusfm_step_phase(dev, teacher, fused)
    cli = cusfm_cli_phase(dev, teacher, fused)
    shutil.rmtree(root, ignore_errors=True)
    return step_launches, cli


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    phase("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from threedgrut_tpu_torch.ops import binning
    from threedgrut_tpu_torch.ops.cameras import make_pinhole, orbit_camera
    from threedgrut_tpu_torch.ops.cuda import build
    from threedgrut_tpu_torch.ops.cuda.expand import (
        expand_decode_pairs, expand_decode_pairs_plain)
    from threedgrut_tpu_torch.ops.cuda.fold import (
        fold_pairs, fold_pairs_plain, invert_permutation,
        invert_permutation_plain)
    from threedgrut_tpu_torch.ops.cuda.raster import (
        rasterize_tiles, rasterize_tiles_backward,
        rasterize_tiles_backward_plain, rasterize_tiles_forward,
        rasterize_tiles_plain, rgb_kernel_attributes)
    from threedgrut_tpu_torch.ops.ut import UTConfig
    from threedgrut_tpu_torch.models.gaussians import (GaussianModel,
                                                       GaussianModelConfig)
    from threedgrut_tpu_torch.render.common import RasterConfig
    from threedgrut_tpu_torch.render.grt import grt_raster_config
    from threedgrut_tpu_torch.render.gut import render_gut
    from threedgrut_tpu_torch.render.oracle import oracle_parity_db
    from threedgrut_tpu_torch.render.serve import make_serving_renderer
    from threedgrut_tpu_torch.synthetic import bench_cloud, orbit_geometry

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    build.load_all(list(LIBS), verbose=True)
    phase("build", f"{' + '.join(LIBS)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in build.BUILD_SECONDS.items())
          + f") -> {build.BUILD_DIR}")

    ut_cfg = UTConfig()
    rc = RasterConfig()
    model = bench_cloud(100_000, seed=0, device=dev)
    cam = make_pinhole((SIDE, SIDE), (1.1 * SIDE, 1.1 * SIDE),
                       (SIDE / 2, SIDE / 2), device=dev)
    grid = (SIDE // 16, SIDE // 16)
    report = {}

    # 3. kernel A vs plain
    v, b_args, fwd, c_args = view_inputs(
        cam, ut_cfg, rc, model, 3, seeded_upstream(dev, SIDE, SIDE,
                                                   (3, 1, 1), 7))
    with torch.no_grad():
        s = binning.pair_slots(v.proj, grid, ut_cfg.alpha_threshold)
        a_args = (s.rows, s.order, s.excl, s.counts, s.total, grid)
        got = binning.sort_pairs(*expand_decode_pairs(*a_args),
                                 grid[0] * grid[1])
        ref = binning.sort_pairs(*expand_decode_pairs_plain(*a_args),
                                 grid[0] * grid[1])
        torch.cuda.synchronize()
        names = ("pair_tile", "pair_particle", "tile_start")
        for nm, g, r in zip(names, got, ref):
            if not torch.equal(g, r):
                bad = int((g != r).sum())
                raise AssertionError(f"kernel A: {nm} differs at {bad} slots")
        a_err = max(float((g - r).abs().max()) if g.numel() else 0.0
                    for g, r in zip(got, ref))
        a_ms = cuda_ms(lambda: expand_decode_pairs(*a_args), 20)
        a_dev_ms = device_ms(lambda: expand_decode_pairs(*a_args), 20)
        a_plain_ms = cuda_ms(lambda: expand_decode_pairs_plain(*a_args), 5)
    n_pairs = int(got[2][-1])
    report["bin_decode"] = dict(
        max_abs_err=a_err, ms=a_ms, device_ms=a_dev_ms, plain_ms=a_plain_ms,
        **bound_keys(bound(nbytes(*a_args[:4],
                                  *expand_decode_pairs(*a_args)),
                           s.total * CULL_FLOPS)))
    phase("kernel A", f"{s.total} slots, {n_pairs} pairs after the cull: "
          f"pair_tile, pair_particle, tile_start equal to plain; "
          f"kernel {a_ms:.4f} ms (device {a_dev_ms:.4f}), plain "
          f"{a_plain_ms:.4f} ms")

    # 4. kernel B vs plain
    with torch.no_grad():
        got = fwd
        ref = rasterize_tiles_plain(*b_args)
        torch.cuda.synchronize()
        err_f = float((got[0] - ref[0]).abs().max())
        err_o = float((got[1] - ref[1]).abs().max())
        err_t = float((got[4] - ref[4]).abs().max())
        err_d = float(((got[2] - ref[2]).abs()
                       / ref[2].abs().clamp(min=1e-3)).max())
        flips = float((got[3] != ref[3]).float().mean())
        b_ms = cuda_ms(lambda: rasterize_tiles_forward(*b_args), 20)
        b_plain_ms = cuda_ms(lambda: rasterize_tiles_plain(*b_args), 3)
        b_share, b_cull, cull_msg = cull_check(b_args, "kernel B")
    if not (err_f <= 1e-4 and err_o <= 1e-4 and err_t <= 1e-4
            and err_d <= 1e-3 and flips < 0.01):
        raise AssertionError(
            f"kernel B vs plain: features {err_f:.3g}, opacity {err_o:.3g},"
            f" T_final {err_t:.3g}, depth rel {err_d:.3g}, "
            f"hits flip {flips:.4f}")
    b_accepted = composited(ref)
    b_res = rgb_kernel_attributes("raster_fwd")["rgb_2_w0"]
    report["raster_fwd"] = dict(max_abs_err=max(err_f, err_o, err_t),
                                ms=b_ms, plain_ms=b_plain_ms,
                                culled_share=b_share, resources=b_res,
                                **rgb_bound_keys(b_args, got, rc, b_cull,
                                                 b_accepted))
    phase("kernel B", f"features |d| {err_f:.3g}, opacity |d| {err_o:.3g}, "
          f"T_final |d| {err_t:.3g}, depth rel {err_d:.3g}, "
          f"hits flip {flips:.5f}; "
          f"kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms; {cull_msg}; "
          f"{resources(b_res)}")

    # 5. against the JAX package's values
    fx = os.path.join(REPO, "tests", "fixtures", "torch_port_gut_small.npz")
    with np.load(fx) as f:
        small, small_cam = fixture_scene(f, dev)
        with torch.no_grad():
            out = render_gut(small_cam, ut_cfg, rc, small,
                             int(f["sh_degree"]))
        e_feat = float(np.abs(out["pred_features"].cpu().numpy()
                              - f["pred_features"]).max())
        e_opac = float(np.abs(out["pred_opacity"].cpu().numpy()
                              - f["pred_opacity"]).max())
        e_dist = float(np.abs(out["pred_dist"].cpu().numpy()
                              - f["pred_dist"]).max())
        flip = float((out["hits_count"].cpu().numpy()
                      != f["hits_count"]).mean())
        same_pairs = int(out["num_pairs"]) == int(f["num_pairs"])
    if not (e_feat <= 1e-4 and e_opac <= 1e-4 and e_dist <= 1e-3
            and flip < 0.01 and same_pairs):
        raise AssertionError(
            f"against JAX: features {e_feat:.3g}, opacity {e_opac:.3g}, "
            f"depth {e_dist:.3g}, hits flip {flip:.4f}, "
            f"pairs equal {same_pairs}")
    phase("vs JAX", f"fixture {os.path.basename(fx)}: features {e_feat:.3g}"
          f", opacity {e_opac:.3g}, depth {e_dist:.3g}, hits flip {flip}, "
          f"num_pairs equal")

    # 6. serving slice
    center, dist = orbit_geometry(model)
    cams = [orbit_camera(az, 0.35, dist, center=center,
                         resolution=(SIDE, SIDE), device=dev)
            for az in np.linspace(0.0, 2 * math.pi, N_VIEWS, endpoint=False)]
    serve = make_serving_renderer(model, rc, sh_degree=3, ut_cfg=ut_cfg)
    serve(cams)                              # warm-up (allocator, caches)
    torch.cuda.synchronize()
    expand_decode_pairs.launches = 0
    rasterize_tiles.launches = 0
    t0 = time.perf_counter()
    imgs = serve(cams)
    torch.cuda.synchronize()
    per_batch = [(time.perf_counter() - t0) * 1e3 / N_VIEWS]
    launches = {"bin_decode": expand_decode_pairs.launches,
                "raster_fwd": rasterize_tiles.launches}
    # more batches for the time only: the host clock varies per batch
    for _ in range(4):
        t0 = time.perf_counter()
        serve(cams)
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3 / N_VIEWS)
    ms_frame = float(np.median(per_batch))
    if launches != {"bin_decode": N_VIEWS, "raster_fwd": N_VIEWS}:
        raise AssertionError(f"serving launches {launches}, "
                             f"expected {N_VIEWS} each")
    if tuple(imgs.shape) != (N_VIEWS, SIDE, SIDE, 3):
        raise AssertionError(f"serving output shape {tuple(imgs.shape)}")
    if not bool(torch.isfinite(imgs).all()):
        raise AssertionError("serving output has non-finite values")
    coverage = [float((im.amax(dim=-1) > 1e-3).float().mean()) for im in imgs]
    if min(coverage) < 0.05:
        raise AssertionError(f"serving coverage too low: {coverage}")
    phase("serving", f"{N_VIEWS} views {SIDE}x{SIDE}, 100k Gaussians, SH 3: "
          f"{ms_frame:.3f} ms/frame ({1e3 / ms_frame:.1f} FPS) host clock, "
          f"median of {len(per_batch)} batches (min {min(per_batch):.3f}, "
          f"max {max(per_batch):.3f}); "
          f"launches {launches}; coverage min {min(coverage):.3f}")

    # 7. oracle probe
    side, n = 200, 60_000
    bulk, raw, flip = oracle_parity_db(
        bench_cloud(100_000, seed=0, device=dev), ut_cfg, rc, side, n)
    if not (bulk >= 80.0 and flip <= 0.01):
        raise AssertionError(f"oracle probe: bulk {bulk:.1f} dB, "
                             f"flip_frac {flip:.5f}")
    phase("oracle", f"{side}x{side}, {n} particles: bulk {bulk:.1f} dB, "
          f"raw {raw:.1f} dB, flip_frac {flip:.5f}")

    # 8. kernel C vs plain: seeded upstream gradients on the same view, and
    # bitwise repeatability
    rgb_res = rgb_kernel_attributes()
    with torch.no_grad():
        d_rec = rasterize_tiles_backward(*c_args)
        c_same = bool(torch.equal(d_rec, rasterize_tiles_backward(*c_args)))
        d_ref = rasterize_tiles_backward_plain(*c_args)
        torch.cuda.synchronize()
        c_stats = {}
        for nm, sl in (("a", slice(0, 3)), ("M", slice(3, 12)),
                       ("density", slice(12, 13)), ("rgb", slice(13, 16))):
            x = d_rec[:, sl].double().flatten()
            y = d_ref[:, sl].double().flatten()
            cos = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
            rel = float((x - y).norm() / y.norm().clamp(min=1e-300))
            c_stats[nm] = (cos, rel)
        c_err = float((d_rec - d_ref).abs().max())
        c_ms = cuda_ms(lambda: rasterize_tiles_backward(*c_args), 10)
        c_plain_ms = cuda_ms(lambda: rasterize_tiles_backward_plain(*c_args),
                             1)
    bad = {k: v for k, v in c_stats.items()
           if not (v[0] >= 0.9999 and v[1] <= 1e-3)}
    if bad or not c_same:
        raise AssertionError(f"kernel C vs plain (cosine, rel L2): {bad}; "
                             f"bitwise repeatable {c_same}")
    res = rgb_res["rgb_2_w0"]
    report["raster_bwd"] = dict(max_abs_err=c_err, ms=c_ms,
                                plain_ms=c_plain_ms, resources=res,
                                **bound_keys(raster_bound(
                                    c_args, [d_rec], rc, False, b_accepted,
                                    BWD_ACCEPT_FLOPS[(rc.kernel_degree,
                                                      False)])))
    phase("kernel C", ", ".join(f"{k} cos {v[0]:.8f} relL2 {v[1]:.3g}"
                                for k, v in c_stats.items())
          + f"; max |d| {c_err:.3g}; two runs bitwise equal; kernel "
          f"{c_ms:.4f} ms, plain {c_plain_ms:.4f} ms; {resources(res)}")

    # 9. kernel D vs plain, and bitwise determinism: as render_gut's
    # backward calls it (the binning's FoldMeta: perm, inverted by D's
    # library, and n_valid), and the inversion alone
    vb = v.binning
    d_args = (d_rec, vb.perm, vb.order, vb.excl, vb.counts, vb.limit,
              model.capacity, None, vb.num_pairs)
    with torch.no_grad():
        keys, d_scale, d1 = fold_check(lambda: fold_pairs(*d_args),
                                       lambda: fold_pairs_plain(*d_args),
                                       "16 wide")
        d_lib_ms = index_add_ms(d_args)
        inv = invert_permutation(vb.perm)
        if not torch.equal(inv, invert_permutation_plain(vb.perm)):
            raise AssertionError("D's inversion differs from the plain one")
        inv_keys = dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: invert_permutation(vb.perm), 20),
            device_ms=device_ms(lambda: invert_permutation(vb.perm), 20),
            plain_ms=cuda_ms(lambda: invert_permutation_plain(vb.perm), 20))
        inv_lib_ms = cuda_ms(lambda: torch.argsort(vb.perm), 20)
    report["fold"] = dict(
        **keys, **bound_keys(fold_bound(
            d_rec, int(vb.num_pairs), (vb.perm, *d_args[2:5],
                                       vb.num_pairs), d1),
            library_ms=d_lib_ms))
    report["fold_invert"] = dict(
        **inv_keys, **bound_keys(bound(nbytes(vb.perm, inv), 0),
                                 library_ms=inv_lib_ms))
    phase("kernel D", f"16 wide, {vb.limit} pairs ({int(vb.num_pairs)} "
          f"before the culled): {fold_msg(keys, d_scale, d_lib_ms)}; its "
          f"inversion equal to plain, {inv_keys['ms']:.4f} ms (device "
          f"{inv_keys['device_ms']:.4f}), plain {inv_keys['plain_ms']:.4f} "
          f"ms, argsort {inv_lib_ms:.4f} ms")

    # 10. render gradients against the JAX package's
    grad_fx = os.path.join(REPO, "tests", "fixtures",
                           "torch_port_grad_small.npz")
    with np.load(grad_fx) as f:
        gmodel, gcam = fixture_scene(f, dev)
        out = render_gut(gcam, ut_cfg, rc, gmodel, int(f["sh_degree"]))
        fixture_loss(out).backward()
        g_errs = {}
        for k in PARAM_NAMES:
            got_g = getattr(gmodel, k).grad.double().cpu().numpy()
            ref_g = f[f"grad/{k}"].astype(np.float64)
            scale = np.abs(ref_g).max() + 1e-12
            cos = float((got_g * ref_g).sum() / max(
                np.linalg.norm(got_g) * np.linalg.norm(ref_g), 1e-300))
            g_errs[k] = (float(np.abs(got_g - ref_g).max() / scale), cos)
    bad = {k: v for k, v in g_errs.items()
           if not (v[0] <= 2e-3 and v[1] >= 0.9999)}
    if bad:
        raise AssertionError(f"gradients vs JAX (max-normalised error, "
                             f"cosine): {bad}")
    phase("grad vs JAX", f"fixture {os.path.basename(grad_fx)}: " + ", ".join(
        f"{k} {v[0]:.2g}/{v[1]:.7f}" for k, v in g_errs.items()))

    # 11. train step: bench.py's step at 100k / 800x800 / SH 3
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from bench_train_torch import BenchStep, time_steps

    step = BenchStep(dev)
    time_steps(step, 3)                       # warm-up
    counters = (expand_decode_pairs, rasterize_tiles,
                rasterize_tiles_backward, fold_pairs, invert_permutation)
    for fn in counters:
        fn.launches = 0
    step_ms, losses = time_steps(step, TRAIN_STEPS)
    launches = dict(zip(("bin_decode", "raster_fwd", "raster_bwd", "fold",
                         "fold_invert"),
                        (fn.launches for fn in counters)))
    if any(n != TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"train-step launches {launches}, expected "
                             f"{TRAIN_STEPS} each")
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError("train-step loss not finite")
    for k, p in step.params.items():
        if not (bool(torch.isfinite(p.grad).all())
                and float(p.grad.abs().max()) > 0.0):
            raise AssertionError(f"train-step gradient of {k} is not "
                                 "finite and non-zero")
    phase("train step", f"100k Gaussians, {SIDE}x{SIDE}, SH 3, L1+DSSIM, "
          f"Adam: {step_ms:.3f} ms/step ({1e3 / step_ms:.2f} it/s) host "
          f"clock over {TRAIN_STEPS} steps; loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}; launches {launches}")
    del step

    # 12. trainer: GS densify / prune / reset on teacher views
    trainer_phase(dev)

    # 13-18. the 3DGRT and sorted-3DGUT path
    report.update(sorted_kernel_phases(dev, b_args, fwd, c_args, v, model,
                                       ut_cfg))
    grt_grad_phase(dev, ut_cfg)
    for label, src in sorted_settings().items():
        launches.update(sorted_train_step_phase(dev, label, src))
    launches["wmax"] = trainer_phase(dev, grt_raster_config(),
                                     prune_weight=True)

    # 19-25. the rolling-shutter and fisheye path
    report.update(general_kernel_phases(dev, model, ut_cfg))
    general_grad_phase(dev, ut_cfg)
    for label, grc in general_settings().items():
        got = camera_train_step_phase(dev, f"rolling {label}", grc,
                                      "rolling", general=True)
        for k in ("raster_fwd_general", "raster_bwd_general"):
            launches[k + GENERAL[label]] = got[k]
    camera_train_step_phase(dev, "fisheye 3DGUT", rc, "fisheye",
                            general=False)
    launches["wmax_general"] = trainer_phase(dev, prune_weight=True,
                                             camera="rolling")
    camera_serving_phase(dev, model, ut_cfg, "rolling", general=True)
    camera_serving_phase(dev, model, ut_cfg, "fisheye", general=False)
    cli_phase(dev)

    # 26-30. the NHT path under MCMC
    report.update(nht_kernel_phases(dev, ut_cfg, cam))
    nht_grad_phase(dev, ut_cfg)
    for label in NHT_CONFIGS:
        launches.update(nht_train_step_phase(dev, label))
    nht_trainer_phase(dev)

    # 31-36. trace() and the playground
    trace_report, trace_launches = trace_phases(dev, ut_cfg)
    report.update(trace_report)
    launches.update(trace_launches)
    launches.update(playground_phase(dev))

    # 37-40. kernels F, G and H, and the table route
    report["scatter_rows"] = scatter_phase(dev, v, c_args)
    launches["scatter_rows"], report["scatter_rows"]["setup_launches"] = (
        table_route_phase(dev, v, b_args, c_args, fwd))
    for entries, counts in (expand_phase(dev, v, s), fill_phase(dev)):
        report.update(entries)
        launches.update(counts)

    # 41. the evaluation path through the CLIs
    for k, by_entry in eval_phase(dev).items():
        report[k]["eval_launches"] = by_entry

    # 42-43. the cuSFM path: the ISP, the full-width step, the CLIs
    step_launches, cli = cusfm_phases(dev)
    for k in CUSFM_KERNELS:
        report[k]["cusfm_launches"] = {
            "step": step_launches["ppisp"][k],
            "step_no_ppisp": step_launches["no_ppisp"][k], **cli[k]}

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches.get(k, 0), **report[k])
               for k, (src, rep) in KERNELS.items()]
    if not (all(k["launches"] > 0 for k in kernels)
            and report["scatter_rows"]["setup_launches"] > 0):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
