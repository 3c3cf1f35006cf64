#!/usr/bin/env python3
"""Drive the renderer's main path on one CUDA card and check every kernel.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
an NVIDIA H100 (sm_90a), the CUDA toolkit and PyTorch built for CUDA.

Phases (one JSON line each):
  1. device: card name and power limit, build time and the ``-Xptxas -v``
     report of each kernel (the kernels are built here from ``csrc/``);
     resources: the registers, spills and shared memory of K4, K5, K6 and
     K0b, and of each instantiation of K1, K2 and K3 (parity and analytic,
     K2's camera one, K1's and K2's segment ones, K2's segment camera one)
     and of K8 and K9.
  2. tf_lookup_fwd (K0) through ``tf_lookup`` at 2^23 intensities, R = 128
     and 4096, against ``tf_lookup_reference``, timed beside ``grid_sample``.
  2b. tf_lookup_bwd (K0b) through ``tf_lookup`` and ``torch.autograd.grad``
     at the same sizes and at R = 16384 (above the shared-memory limit:
     global atomics), against ``tf_lookup_bwd_reference``, timed beside the
     gradient of ``grid_sample``.
  3. march_diff_fwd (K1) through ``Raycaster.forward`` at the bench workload
     (256^3 volume, tf1 at R = 128, 512^2 image, max_samples 512, sr 1,
     jittered), on a noise volume and on a CT phantom, against
     ``march_diff_plain``; K1's zero-opacity skips and the distinct voxels
     of its samples' stencils (``stencil_footprint``).
  3b. march_diff_bwd (K2) through ``Raycaster.forward`` and
     ``mean(img^2).backward()`` on both scenes: one K1 and one K2 launch
     per step, K2's per-ray counts equal to K1's, finite gradients; both
     gradients against autograd of ``march_diff_plain`` at 512^2 with ERT
     (summed over 16 tiles of 128^2 rays) and at a 128^2 image with ERT off
     and on, also at normal_delta 6e-3 (0.765 voxel), where most samples
     take the stencil's general branch (K1 there without ERT against the
     plain march); K2's atomics; ``grad_step_ms``.
  4. march_nondiff (K3) through ``Raycaster.raycast_nondiff`` (sr 4) on both
     scenes: one K6 and one K7 launch (the occupancy grid's build) and one
     K3 launch that jumps over empty space; K3 without the grid against
     ``march_nondiff_plain`` without it, K3 with the grid bitwise equal to
     K3 without it (image and composited counts on every ray), and against
     ``march_nondiff_plain`` with the grid; K3's per-ray counts (cell loads,
     extra-layer loads, grid reads), its cell loads equal to the plain
     march's count of centre-cell changes on every ray outside the ERT knife
     edge, with and without the grid; ``raycast_ms`` with the grid and
     without it (``occupancy_skip=False``), timed alternately.
  5. profile: device time by kernel and the busy share of the forward, the
     gradient step and the inference render on the noise scene, the last
     with the occupancy grid and without it (torch.profiler).
  5b. train: 5 steps of the volume-fitting loop of
     ``examples/optimize_volume.py`` at 256^3 and 512^2, 2 views of one
     volume: one K1 launch a step (``render_batch``), one K2 a view.
  6. golden: the card's renders of the sphere fixtures of
     ``tests/golden_renders.npz``, and K2 on that sphere at sampling rate
     0.8 against the plain march and through ``value_and_grad_render``.
  7. bricks: brick_sums (K4) and brick_rows (K5), the three variants of the
     TPU DMA probe ``experiments/exp_pallas_dma.py`` at its sizes and seeds
     (256^3 volume, 32^3 bricks, 2048 origins aligned and unaligned, a
     4096-brick table), against their plain versions at ``rtol=1e-5``, and
     origins out of range giving NaN rows; each kernel bitwise equal across
     calls and to its C entry; K4 also at 16 and 16384 unaligned origins,
     on a 250x256x243 volume (4-byte copies) and on a base that is not
     16-byte aligned, its time at 16384 under 16x its time at 2048; K5 also
     with every index equal and with duplicates among indices out of range.
     Times by CUDA events around back-to-back calls of the C entries, with
     the wrapper call's beside them; the bytes each kernel reads by design.
  8. occupancy: cell_minmax (K6), cell_distance (K7) and ``build_occupancy``
     at 256^3 on noise and ct_phantom, auto cell (2, max_dist 48) and cell 8
     (max_dist 12): K6 and K7 equal to their plain versions (K7 also at
     R = 4096), the card's grid equal to the whole build on CPU copies of
     the volume and the TF; K6's and K7's device time and launches per call
     (CUDA events around back-to-back calls of their C entries: a wrapper
     call's host work outlasts K7 on the device), K6
     beside its library form (two ``max_pool3d`` calls); K6 also on a
     250x256x243 volume at cells 2, 3, 8 and 48 (sides the cell does not
     divide; at 48 a tile's voxels are taken in bands) equal to its plain
     version and to the CPU build.
  9. viewer: the JAX package's inference example at full width (800^2,
     sampling rate 16, tf1, camera (0, 1, -2.3)) on its synthetic volume and
     ct_phantom at 256^3: K3 with the grid bitwise equal to K3 without it,
     and against the plain march with the grid on the same 800^2 rays
     (with K3's cell loads against its count); samples visited, K3's counts
     and ``raycast_ms`` with and without the grid.
  9b. analytic: ``analytic_normals=True`` at the bench workload on noise
     and ct_phantom, through a Raycaster of that config: K1 against the
     plain march (ERT on and off), no sample in the stencil's general
     branch; a gradient step (one K1, one K2, no camera launch) and K2
     against autograd of the plain march summed over 4 of the 16 tiles of
     128^2 (a corner and an edge tile on the box's silhouette, two central
     ones; a cotangent that is 0 on the other 12);
     ``raycast_nondiff`` (one K6, K7, K3), K3 with the grid bitwise K3
     without it and against the plain march, no voxel loaded beyond the
     cached cell; K1, K2 and K3 timed beside the parity instantiations;
     K3 at the viewer workload (800^2, sampling rate 16) against the plain
     march on every ray and timed, with the grid bitwise equal to K3
     without it.
  9c. camera: at 128^2 on noise (ERT on and off) and on the golden sphere,
     parity and analytic: K2's camera instantiation's 12 per-ray sums
     against ``march_diff_cotangents_plain`` per ray, the cotangents of
     ``march_diff``'s ray tensors against autograd of the plain march in
     them (per ray, and per tile in the origin), its d_volume and d_tf
     against K2's default ones, and ``d_look_from`` of ``render`` against
     the plain cotangents pulled through the ray setup; a default gradient
     step launches no camera instantiation; at 512^2, ``grad_step_ms`` with
     and without the camera gradient, called in turn, the same checks at
     the step's rays and cotangent over 16 tiles of 128^2, the step's
     ``d_look_from`` against the plain one, and K2's camera instantiation
     timed beside the default one.
  9d. strips: ``render_nondiff_strips`` (4 strips, 4 K3 launches) at the
     viewer on synthetic and ct_phantom, bitwise ``render_nondiff``;
     ``render_strips``' gradient step at the bench on noise (4 K1, 4 K2):
     image and counts bitwise ``render``'s, gradients within
     K2_GRAD_TOL * max|g|; each timed in turn with its monolithic form.
  9e. depth_sorted: ``render_depth_sorted`` (4 chunks) at the bench on
     noise and ct_phantom, the same checks; ``grad_step_ms`` sorted and
     unsorted in turn, and K1's and K2's device time in each.
  9f. policy: ``choose_diff_renderer`` (heuristic) on both scenes with its
     two statistics; the timed probe on ct_phantom, whose choice renders
     within 1e-5 * max of ``render``.
  9g. blockwise512: ``value_and_grad_blockwise`` on a 512^3 uniform volume
     (x 0.5, seed 1) at 512^2 with ``march_vjp="sorted"`` and
     ``march_table="super64s2"``: one K1 and one K2, the loss equal to
     ``value_and_grad_render``'s, gradients within K2_GRAD_TOL; peak
     memory; K1 (image, counts) and K2 (gradients within K2_GRAD_TOL) at
     512^3 against the plain march on a silhouette corner tile and a
     central tile of 128^2; a batched ``Raycaster.forward`` gradient step
     of 2 views, each view's image bitwise ``render`` on that view alone
     and its gradients within K2_GRAD_TOL.
  9h. fastpath: ``render_fast`` at 256^3, 512^2, O = 576, 2 planes per
     voxel on noise and ct_phantom: one K8 ``shear_warp_fwd`` launch per
     forward and one K8 plus one K9 ``shear_warp_bwd`` per gradient step,
     nothing else; against ``render_fast_plain`` (image within 1e-5,
     ``hit`` equal, gradients within K2_GRAD_TOL); the image bitwise across
     calls, at slab batches 32 and 2 and with TF32 allowed; rows [O/4,
     O/2) marched as a strip bitwise the whole image's; at O = 128 (few
     pixels per texel), and at 64^3, O = 96 with a TF whose alpha reaches 1
     and with 4 planes per voxel, each against the plain version with no
     NaN; forward and step times (the plain ones beside) and the step's
     own peak memory beside K3's ``render_nondiff`` at the same view; K8
     and K9 timed by CUDA events around their C entries (K9 on the step's
     own cotangent), with their plain versions' times; K8's per-pixel
     samples taken equal to the in-footprint samples before each pixel's
     stop plane, counted from the geometry, and K9's restarts; the bounds
     over those samples and the layer texels they need; SSIM against
     ``render`` and ``choose_fast_params``' record; K0b's dot mask on
     quantised intensities; ``Raycaster.raycast_fast`` at the viewer (O =
     1024, one K8) against ``raycast_nondiff`` (SSIM, times), K8 timed
     there beside its plain version and its bound, its samples taken
     checked as at the bench.
  9i. parallel: one NCCL rank (the card's machine has one card), backend
     and NCCL version printed; at the bench on noise and ct_phantom the K =
     4 shards' segments (``pad_halos``, K1's segment instantiation through
     ``segment_march``, ``compose_segments``) against K1's ``render(...,
     ert=False)`` (image within 2e-4, ``valid_steps`` equal), on noise also
     K = 8; the gradient of mean(image^2) through the 4 segments against
     ``render_volume_sharded``'s at world size 1 (one launch of each
     segment kernel, one segment over the whole volume) within
     K2_GRAD_TOL, its d_tf against K2's ``render(..., ert=False)`` (whose
     d_volume follows the other TF rule at integer t: the voxels where they
     part are counted); the same world-size-1 step against
     ``segment_march_plain`` on three tiles of 128^2 of its 512^2 rays (a
     silhouette corner, a central tile and the tile whose cotangent alone
     parts the two kernels' d_volumes most; the cotangent 0 elsewhere and
     on rays with a sample on a kink of the shading, n.l = 0 or light = 1
     within 1e-6, at most 0.1% of the tiles' rays):
     image within 2e-4, ``valid_steps`` equal, d_volume and d_tf within
     K2_GRAD_TOL, and K2's ``render(..., ert=False)`` against the plain
     march there too, the parting voxels counted in both pairs; at 128^2
     on noise
     each shard's K1 and K2 segment against ``segment_march_plain`` and its
     autograd, and at K = 8 with a quarter-length window at JAX's side-on
     camera; at world size 1 ``render_views`` (each view bitwise
     ``render``'s), ``view_parallel_grads`` and ``train_step_views`` (both
     modes, and the shear-warp renderer at 128^3 / 256^2: two K8 and two
     K9) against the serial mean-loss gradient, ``render_fast_sharded``
     (one K8) bitwise ``render_fast`` and 4 row strips bitwise its
     intermediate image; the
     segment kernels per shard and summed over 4 beside K1 and K2 without
     ERT on the whole volume, the entry points' wall times beside
     ``render``'s.  The camera gradient through the segments (K2's
     segment camera instantiation): at 128^2 on noise (shards 0 and 1 of
     4) and on the golden sphere (all 4 shards), rays on a shading kink
     masked and counted, each shard's 12 per-ray sums against
     ``segment_cotangents_plain`` (within CAMERA_SUM_TOL of each group's
     largest), the cotangents of ``segment_march``'s ray tensors against
     autograd of ``segment_march_plain`` in them (CAMERA_RAY_TOL), its
     d_padded and d_tf against the default instantiation's; ``d_look_from``
     of ``render_volume_sharded`` at world size 1 against the plain
     segment's and against the 4 segments composed (CAMERA_TOL of its
     norm); at 512^2 the step with and without the camera gradient, timed
     in turn (one K1 segment, one K2 segment camera launch), and held to
     the plain segment march on the three tiles of 128^2 picked above on
     noise (the cotangent 0 off them and on kink rays): K2's sums
     (CAMERA_SUM_TOL), the ray tensors' cotangents (CAMERA_RAY_TOL, 0 off
     the tiles) and the step's ``d_look_from`` (CAMERA_TOL of its norm);
     the camera instantiation timed beside the default one, its
     ``resources``.
  9j. utilities: whether PIL and matplotlib import; ``io.load_raw_volume``
     of a 256^3 uint8 file on the card bitwise numpy's / 255; a
     ``profiling.trace`` around one ``render`` and one ``raycast_nondiff``
     that names K1, K3 and its annotation; a checkpoint round trip of a CUDA tensor, an
     AdamW state and a CUDA generator's state; ``TorchRaycaster`` at the
     bench (image bitwise ``Raycaster``'s with its draw, gradients within
     K2_GRAD_TOL) and its ``raycast_fast`` at the viewer (one K8) bitwise
     ``Raycaster.raycast_fast``.
  9k. examples: ``render_nondiff.run`` at its defaults (800^2, sampling
     rate 16, 4 strips) bitwise ``render_nondiff``; ``optimize_tf.run
     backward`` for 5 iterations at its default widths (the loss falls; one
     K1 and one K2 a step, K2's TF-only instantiation each time);
     ``interactive_viewer.run`` for 3 frames without its server; the
     examples' files written where PIL and matplotlib import.  K2's TF-only
     instantiation at the upstream TF fit's shapes against the plain march
     (:func:`tf_only_k2`).
  9l. view_batch: the volume fit's ground truth in one K3 launch
     (:func:`view_batch`): at its shapes (256^3, 8 views of 256^2,
     sampling rate 8, the grid on) on the benchmark's ``ct_head`` and
     ``dense_sim`` scenes, ``render_nondiff_batch`` (one grid build, one K3
     launch, 8 batched views) and K3 on the views' stacked rays bitwise a
     launch a view (image, visited, composited, counts), and
     ``Raycaster.raycast_nondiff`` of the 8 poses bitwise its view-by-view
     loop; the batched and the looped render and K3 timed in turn; K3's
     registers and spills from ptxas.
  9m. diff_batch: the volume fit's views in one K1 launch
     (:func:`diff_batch`): at its shapes (256^3, 8 views of 256^2,
     sampling rate 1, jittered) on both scenes, K1 on the views' stacked
     rays bitwise a launch a view (image, ``valid_steps``, counts); the
     fitting step through ``Raycaster.forward`` (one K1, a K2 a view)
     against its view-by-view loop (images bitwise, ``d_volume`` and
     ``d_tf`` within K2_GRAD_TOL); K1 and the step timed batched and looped
     in turn, the step's peak memory; K1's registers and spills from ptxas.
  Each of 9d-9m prints its own seconds.
  10. the ``kernels`` line, then the contract line as the last line.
Launch counts are reset just before each entry point is driven and read just
after; launches made to compare or time a kernel do not count.  Any failed
check raises, so the script exits non-zero and prints no result.  It also
exits non-zero where ``torch.cuda.is_available()`` is false.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of f32 outside the tensor cores.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# f32 operations per unit of work that the function needs (transcendentals
# count as one).  A sample's 7 trilinear points share their voxel
# coordinates: each of the 6 gradient points differs from the centre on one
# axis only, so a sample computes 3 + 6 axes, not 21.  The weight of a corner
# is a pair product of two axes' weights times the third's; the centre makes
# the xy, yz and xz pair products once and every point reuses them.
AXIS_OPS = 7 + 1                   # clamp, scale, floor, frac; 1 - frac
PAIR_OPS = 4                       # one axis pair's 4 weight products
POINT_OPS = 8 + 15                 # 8 corner weights, weighted sum
CENTRE_OPS = 3 * AXIS_OPS + PAIR_OPS + POINT_OPS
GRADIENT_POINTS_OPS = 2 * PAIR_OPS + 6 * (AXIS_OPS + POINT_OPS)
POSITION_OPS = 8                   # t = t0 + s*dt, p = o + t*d
STENCIL_OPS = 6 + 3                # +-delta offsets, gradient differences
TF_LERP_OPS = 18
OPACITY_OPS = 4
SHADE_OPS = 59                     # normal, light dir, diffuse, reflect,
                                   # specular, light sum and clamp, rgb
COMPOSITE_OPS = 9                  # rgb += T*c, T *= 1-a, the ERT gate
DIFF_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + GRADIENT_POINTS_OPS
                   + STENCIL_OPS + TF_LERP_OPS + OPACITY_OPS + SHADE_OPS
                   + COMPOSITE_OPS)
NONDIFF_VISIT_OPS = POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + 2
NONDIFF_SHADE_OPS = (GRADIENT_POINTS_OPS + STENCIL_OPS + OPACITY_OPS
                     + SHADE_OPS - 1 + COMPOSITE_OPS - 1)
TF_LOOKUP_OPS = TF_LERP_OPS
# K3's occupancy lookup at a head sample: its position, the macrocell index
# on 3 axes (scale, offset, clamp, multiply, divide, truncate, clamp), the
# flat index, and the jump (d - 1, multiply, divide, cap, compare).
JUMP_OPS = POSITION_OPS + 3 * 8 + 4 + 6
# The backward of a TF lerp: t, max, floor, frac, the low/high clamps and
# 1 - frac (7); 8 weight products and 8 accumulations into d_tf; the slope
# (4 differences, 4 products, 3 sums), times R - 1, and the mask (3).
TF_LERP_BWD_OPS = 7 + 16 + 11 + 1 + 3
TF_LOOKUP_BWD_OPS = TF_LERP_BWD_OPS
# K2, per composited sample: the forward recompute (DIFF_SAMPLE_OPS), then
# the backward chain, each step once.  Composite: the colour cotangent T*g,
# g.c, the prefix, U - P, T_b/f and the product (13).  Shading: d of the TF
# colour and of light*alpha (14), of alpha through the opacity correction
# (8), of the light clamp (2), the specular power (3), r.v (3), the
# reflection (3), n.l (9), the normal (12) and the unit-normal VJP (17).
# The TF lerp backward (TF_LERP_BWD_OPS minus the 7 shared with the
# forward).  The scatter: 7 points x 8 corners, a product and an
# accumulation each, weights shared with the forward, and 3 negations.
COMPOSITE_BWD_OPS = 13
SHADE_BWD_OPS = 14 + 8 + 2 + 3 + 3 + 3 + 9 + 12 + 17
SCATTER_OPS = 7 * 8 * 2 + 3
BWD_SAMPLE_OPS = (DIFF_SAMPLE_OPS + COMPOSITE_BWD_OPS + SHADE_BWD_OPS
                  + TF_LERP_BWD_OPS - 7 + SCATTER_OPS)
# A composited sample whose volume cotangent is exactly 0 (K2 counts the
# others: on these scenes, samples whose two TF texels both have alpha 0,
# such as ct_phantom's empty space and tf1's transparent bands on noise; the
# opacity is 0 there and stays 0 as the intensity moves, so the shaded
# colour is 0 whatever the normal) needs no scatter: its value, TF colour,
# opacity and composite, the composite's backward, alpha's through the
# opacity correction (8) and the TF lerp's (d_tf).  Its d_tf also needs the
# light, so the gradient points and the shading (QUIET_LIGHT_OPS), wherever
# its TF colour and colour cotangent are not 0 (d_alpha = d_la * light +
# d_sh.a with d_la = T g.rgb . c.rgb; K2 counts those samples too).  The
# phase also prints the bound that charges no quiet sample the light.
QUIET_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + OPACITY_OPS
                    + COMPOSITE_OPS + COMPOSITE_BWD_OPS + 8
                    + TF_LERP_BWD_OPS - 7)
QUIET_LIGHT_OPS = GRADIENT_POINTS_OPS + STENCIL_OPS + SHADE_OPS
# A sample of opacity exactly 0 shades to 0 whatever the normal, so K1's
# forward needs of it only the position, the centre, the TF lerp, the
# opacity and the composite (K1 counts them).  The phase also prints the
# bound that charges every sample DIFF_SAMPLE_OPS.
ZERO_OPACITY_OPS = (POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + OPACITY_OPS
                    + COMPOSITE_OPS)
# Analytic mode (analytic_normals): the gradient comes from the centre's 8
# corners already loaded; per axis 8 products and 7 sums (the pair products
# of two more axis pairs, 8) and the scale (3).  K2's scatter: 8 corners, 4
# products and 4 sums each for the value and the three gradient terms, and
# the 3 scaled gradient cotangents.
ANALYTIC_GRADIENT_OPS = 2 * PAIR_OPS + 3 * 15 + 3
DIFF_SAMPLE_OPS_A = (POSITION_OPS + CENTRE_OPS + ANALYTIC_GRADIENT_OPS
                     + TF_LERP_OPS + OPACITY_OPS + SHADE_OPS + COMPOSITE_OPS)
NONDIFF_SHADE_OPS_A = (ANALYTIC_GRADIENT_OPS + OPACITY_OPS + SHADE_OPS - 1
                       + COMPOSITE_OPS - 1)
BWD_SAMPLE_OPS_A = (DIFF_SAMPLE_OPS_A + COMPOSITE_BWD_OPS + SHADE_BWD_OPS
                    + TF_LERP_BWD_OPS - 7 + 8 * 8 + 3)
QUIET_LIGHT_OPS_A = ANALYTIC_GRADIENT_OPS + SHADE_OPS
# K2's camera instantiation against the plain per-sample cotangents summed
# per ray (march_diff_cotangents_plain), per group P, S, L, V: max |diff| /
# max |plain|.  Both sum signed terms per sample in other orders, and S
# weighs the late samples of long rays most.  The ray tensors' cotangents of
# march_diff against autograd of the plain march in them, per tensor, max
# |diff| / max |plain|.  d_look_from against the plain cotangents pulled
# through the ray setup, relative to |d_look_from|.
# K2's camera instantiation, per scattering sample in parity mode: the
# position gradient of the trilinear interpolant at the 7 stencil points
# (3 axes, the 12 pair products, 3 signed sums of 8, 3 slopes, 6 to weigh
# and add it) and the 6 offsets; per sample: the light and view
# directions' cotangents (d(n.l) n + dr, its projection through the
# normalisation, -d_q r: 24) and the 12 sums (15).
POINT_GRADIENT_OPS = 3 * AXIS_OPS + 3 * PAIR_OPS + 3 * 15 + 3 + 6
CAMERA_POSITION_OPS = 7 * POINT_GRADIENT_OPS + 6
CAMERA_SUM_OPS = 24 + 15
CAMERA_SUM_TOL = 1e-3
CAMERA_RAY_TOL = 1e-3
CAMERA_TOL = 1e-4
# K8 shear_warp_fwd, per in-footprint sample: the plane's position, the ray's
# crossing and the two source coordinates (11); the taps of each axis
# (floor, frac, the inside test, the clamps, 1 - frac, two selects: 13 each);
# three 4-channel lerps and the coverage (39); the TF lerp; the shading
# (the unit normal 12, the light direction 14, n.l 5, diffuse 3, the
# reflection 7, the view direction 14, r.v 6, the specular power 4, the
# light and its clamp 3: 68); the opacity correction and the premultiplied
# colour (11); the composite and the gate (9).
SW_SHADE_OPS = 68
SW_SAMPLE_OPS = 11 + 2 * 13 + 39 + TF_LERP_OPS + SW_SHADE_OPS + 11 + 9
# K9, per in-footprint sample: K8's sample again, the composite's backward
# (COMPOSITE_BWD_OPS), the shading terms again, their backward (the colour
# and alpha 26, the two powers' VJPs 17, the light clamp, r.v, the
# reflection and n.l 26, the unit-normal VJP 22: 89), the TF lerp's
# backward, and the scatter (the two lerps' weights 24, the merges 12 and up
# to 16 atomic adds: 52).
SW_BWD_SAMPLE_OPS = (SW_SAMPLE_OPS + COMPOSITE_BWD_OPS + SW_SHADE_OPS + 89
                     + TF_LERP_BWD_OPS - 7 + 52)
# The z-lerp of a slab texel from its two voxel layers (K8 and K9 form
# each needed one): 4 channels, two products and a sum each.
SW_ZLERP_OPS = 12
# K2 against autograd of the plain march, per gradient tensor, times its
# max |g|.  Both run the same f32 arithmetic per sample (the kernels round
# the trilinear sum and the TF lerp as the plain march does); only the order
# of the atomic adds differs, which has stayed below 1e-5 * max |g|.
K2_GRAD_TOL = 1e-4

# K2's TF-only instantiation against the plain march: blocks of
# TF_ONLY_TILE^2 rays, every other one in each direction of the 240^2 image,
# d_tf held to TF_ONLY_TOL * its largest texel.  Not K2_GRAD_TOL: here a
# block of K2 sums ~1e5 terms of both signs on one texel (the air's) with
# f32 atomics, which the full K2 does alike (the two agree within 2.4e-6);
# readings 2.3e-5 to 2.0e-4 against the plain march's float64 sums, two
# runs each of four cases (H100, PR 18), nearly the same in both runs.
TF_ONLY_TILE = 48
TF_ONLY_TOL = 1e-3

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE_MS_IS = ("CUDA events around 20 back-to-back calls of the C entry, "
                "median of 10")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def tf_sums_in_f64(P):
    """The plain march's TF backward (``sampling.tf_lerp_bwd``) with each
    sample's terms formed in float32, as it forms them, and summed per
    texel in float64.  At the TF fit's size a block of rays puts ~1e6
    terms of both signs on one texel (the air's), and their float32 sum
    is off by ~5e-3 of the largest texel (chip_smoke, PR 18)."""
    import torch
    orig = P.sampling.tf_lerp_bwd

    def bwd(tf, intensity, g, mask):
        R = tf.shape[0]
        t = torch.clamp(intensity.reshape(-1) * float(R - 1), min=0.0)
        frac = t - torch.floor(t)
        low = torch.clamp(torch.floor(t), max=float(R - 1)).long()
        high = torch.clamp(low + 1, max=R - 1)
        gm = g.reshape(-1, 4)
        acc = torch.zeros(tf.shape, dtype=torch.float64, device=tf.device)
        acc.index_add_(0, low, ((1.0 - frac)[:, None] * gm).double())
        acc.index_add_(0, high, (frac[:, None] * gm).double())
        return acc.to(tf.dtype), orig(tf, intensity, g, mask)[1]
    P.sampling.tf_lerp_bwd = bwd
    try:
        yield
    finally:
        P.sampling.tf_lerp_bwd = orig


# K3's registers and spill stores a thread, read from ptxas before its launch
# grid took the view axis (one H100 build, parity: 128 registers, 8 bytes of
# spill stores; analytic: 84-86, none); the view axis must keep them.
K3_MAX_REGISTERS = 128
K3_MAX_SPILL_STORES = 8


def cuda_ms_in_turn(dev, fa, fb, reps=10, warm=2):
    """Device ms of ``fa`` and of ``fb`` by CUDA events, the two called in
    turn (``warm`` times each first): the medians of ``reps`` each."""
    import torch
    for _ in range(warm):
        fa()
        fb()
    torch.cuda.synchronize(dev)
    times = ([], [])
    for _ in range(reps):
        for fn, out in zip((fa, fb), times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            out.append((a, b))
    torch.cuda.synchronize(dev)
    return [statistics.median(a.elapsed_time(b) for a, b in t)
            for t in times]


def ptxas_resources(ptxas, kernel: str) -> dict:
    """Per instantiation of ``kernel`` in a ptxas report: its registers a
    thread and its bytes of spill stores."""
    found, cur = {}, None
    for ln in ptxas:
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if kernel in ln else None
        elif cur and ("Used" in ln or "spill" in ln):
            found.setdefault(cur, []).append(ln)
    regs = {k: int(ln.split("Used ")[1].split()[0])
            for k, lns in found.items() for ln in lns if "Used" in ln}
    spills = {k: int(ln.split(" bytes spill stores")[0].split()[-1])
              for k, lns in found.items() for ln in lns
              if "spill stores" in ln}
    return {"report": found, "registers": regs, "spill_stores": spills}


def view_batch(P, dev, ptxas=None, seed: int = 19) -> dict:
    """The volume fit's ground truth as one batched render
    (``render_nondiff_batch``) at the benchmark's shapes (configuration
    ``volfit_256``: 256^3, tf1 at R 128, 8 views of 256^2 at sampling rate
    8, the occupancy grid on) on its ``ct_head`` and ``dense_sim`` scenes
    and one step's poses from ``seed``.  Per scene: one grid build (one K6,
    one K7) and one K3 launch, the 8 views counted in the tally
    ``march_nondiff.views``; K3 on the views' stacked rays bitwise
    8 launches of one view each (image, visited and composited samples,
    per-ray counts); ``Raycaster.raycast_nondiff`` of the 8 poses (one
    launch) bitwise its view-by-view loop (a TF batch of distinct copies:
    8 launches).  The batched render and the loop of 8 ``render_nondiff``
    timed in turn by CUDA events, and K3 alone (one launch of 8 views, 8
    launches).  ``ptxas`` (the build's report of ``march.cu``): every
    instantiation of ``march_nondiff_kernel`` within K3_MAX_REGISTERS and
    K3_MAX_SPILL_STORES.  Returns each scene's readings."""
    import torch
    from dvrbench import harness
    from dvrbench.jobs import volfit

    def sync():
        torch.cuda.synchronize(dev)

    def in_turn(fa, fb):
        return cuda_ms_in_turn(dev, fa, fb)

    out = {}
    if ptxas is not None:
        k3 = ptxas_resources(ptxas, "march_nondiff_kernel")
        regs, spills = k3["registers"], k3["spill_stores"]
        out["resources"] = k3["report"]
        require(len(regs) == 4 and max(regs.values()) <= K3_MAX_REGISTERS
                and max(spills.values()) <= K3_MAX_SPILL_STORES,
                f"K3's registers or spills grew: {k3['report']}")
    cfg_v = harness.config("volfit_256")
    sr = float(cfg_v["gt_sampling_rate"])
    for scene in ("ct_head", "dense_sim"):
        job = volfit.Job(cfg_v, harness.traffic(scene), seed, dev)
        lfs, _ = job.feed()
        rc, cfg = job.rc, job.rc.config
        V = lfs.shape[0]
        H, W = cfg.image_shape
        vol = P.volume_to_internal(job.vol_gt[0]).contiguous()
        tf = P.tf_to_internal(job.tf).contiguous()
        label = f"view_batch on {scene}"

        sync()
        P.reset_launch_counts()
        batch = P.render_nondiff_batch(vol, tf, lfs, cfg, sr)
        sync()
        n = P.launch_counts()
        require(n["march_nondiff"] == 1 and n["cell_minmax"] == 1
                and n["cell_distance"] == 1
                and n["march_nondiff.views"] == V,
                f"{label}: launches {n}")
        loop = torch.stack([P.render_nondiff(vol, tf, lf, cfg, sr).image
                            for lf in lfs])
        require(torch.equal(batch.image, loop),
                f"{label}: the batched render is not the loop's")

        grid = P.build_occupancy(vol, tf, cfg)
        per_view = [P.make_rays(lf, cfg, sr) for lf in lfs]
        rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
        counts = torch.empty((V, H, W, 3), dtype=torch.int32, device=dev)
        got = P.march_nondiff(vol, tf, rays, cfg, sr, grid, counts=counts)
        one = torch.empty((H, W, 3), dtype=torch.int32, device=dev)
        for v, r in enumerate(per_view):
            want = P.march_nondiff(vol, tf, r, cfg, sr, grid, counts=one)
            require(all(torch.equal(g[v], w) for g, w in zip(got, want))
                    and torch.equal(counts[v], one),
                    f"{label}: K3's view {v} in the batch is not its own "
                    f"launch's")

        vol_u, tf_u = job.vol_gt, job.tf
        sync()
        P.reset_launch_counts()
        rc_batch = rc.raycast_nondiff(vol_u, tf_u, lfs, sr)
        sync()
        k3_batch = P.launch_counts()["march_nondiff"]
        P.reset_launch_counts()
        rc_loop = rc.raycast_nondiff(vol_u, tf_u[None].repeat(V, 1, 1), lfs,
                                     sr)
        sync()
        k3_loop = P.launch_counts()["march_nondiff"]
        require(k3_batch == 1 and k3_loop == V
                and torch.equal(rc_batch, rc_loop),
                f"{label}: raycast_nondiff launched K3 {k3_batch}x batched, "
                f"{k3_loop}x looped, images equal "
                f"{bool(torch.equal(rc_batch, rc_loop))}")

        render_ms = in_turn(
            lambda: P.render_nondiff_batch(vol, tf, lfs, cfg, sr),
            lambda: [P.render_nondiff(vol, tf, lf, cfg, sr) for lf in lfs])
        k3_ms = in_turn(
            lambda: P.march_nondiff(vol, tf, rays, cfg, sr, grid),
            lambda: [P.march_nondiff(vol, tf, r, cfg, sr, grid)
                     for r in per_view])
        out[scene] = {
            "views": V, "image": [H, W], "sampling_rate": sr, "launches": n,
            "visited": int(got[1].sum()), "composited": int(got[2].sum()),
            "cell_loads": int(counts[..., 0].sum()),
            "grid_reads": int(counts[..., 2].sum()),
            "render_ms": {"batched": render_ms[0], "looped": render_ms[1]},
            "k3_ms": {"batched": k3_ms[0], "looped": k3_ms[1]},
            "k3_ns_per_ray": {"batched": k3_ms[0] * 1e6 / (V * H * W),
                              "looped": k3_ms[1] * 1e6 / (V * H * W)}}
        del job, vol, tf, grid, rays, got, counts, batch, loop
        torch.cuda.empty_cache()
    return out


# K1's registers and spill stores a thread, read from ptxas before its launch
# grid took the view axis (one H100 build: parity 96 registers, 8 bytes of
# spill stores; analytic 72-74, none; segment 96 and 8): 5 blocks of 128
# threads an SM (__launch_bounds__(128, 5)) allow 102 registers, and the
# view axis must add no spill.
K1_MAX_REGISTERS = 102
K1_MAX_SPILL_STORES = 8


def diff_batch(P, dev, ptxas=None, seed: int = 21) -> dict:
    """The volume fit's views in one K1 launch (``render_batch``) at the
    benchmark's shapes (configuration ``volfit_256``: 256^3, tf1 at R 128,
    8 views of 256^2 at sampling rate 1, 1024 samples, jittered) on its
    ``ct_head`` and ``dense_sim`` scenes, the fitted (corrupted) volume and
    one step's poses and jitter from ``seed``.  Per scene: K1 on the views'
    stacked rays (one launch, the 8 views tallied in
    ``march_diff_fwd.views``) bitwise 8 launches of one view each (image,
    ``valid_steps``, per-ray counts); the job's step through
    ``Raycaster.forward`` and the loss's backward (one K1 launch, 8 K2) with
    its images bitwise and its ``d_volume`` and ``d_tf`` within
    K2_GRAD_TOL of their largest of the Raycaster's view-by-view loop (a TF
    batch of distinct copies: 8 K1 and 8 K2 launches); K1 timed by CUDA
    events batched and a launch a view in turn, the step likewise, and the
    step's peak memory both ways.  ``ptxas`` (the build's report of
    ``march.cu``): K1's parity and analytic instantiations within
    K1_MAX_REGISTERS and K1_MAX_SPILL_STORES.  Returns each scene's
    readings."""
    import torch
    from dvrbench import harness
    from dvrbench.jobs import volfit

    def sync():
        torch.cuda.synchronize(dev)

    out = {}
    if ptxas is not None:
        k1 = ptxas_resources(ptxas, "march_diff_fwd_kernel")
        # Mangled names end in the template flags <kGlobalTf, kAnalytic,
        # kSegment>: Lb0E/Lb1E; the segment ones (kSegment true) end in
        # Lb1EEv.
        whole = {k: r for k, r in k1["registers"].items()
                 if not k.endswith("Lb1EEv9MarchArgs")}
        spills = {k: k1["spill_stores"].get(k, 0) for k in whole}
        out["resources"] = k1["report"]
        require(len(whole) == 4
                and max(whole.values()) <= K1_MAX_REGISTERS
                and max(spills.values()) <= K1_MAX_SPILL_STORES,
                f"K1's registers or spills grew: {k1['report']}")
    cfg_v = harness.config("volfit_256")
    sr = float(cfg_v["sampling_rate"])
    for scene in ("ct_head", "dense_sim"):
        job = volfit.Job(cfg_v, harness.traffic(scene), seed, dev)
        lfs, u = job.feed()
        rc, cfg = job.rc, job.rc.config
        V = lfs.shape[0]
        H, W = cfg.image_shape
        vol = P.volume_to_internal(job.vol.detach()[0]).contiguous()
        tf = P.tf_to_internal(job.tf).contiguous()
        label = f"diff_batch on {scene}"

        per_view = [P.make_rays(lf, cfg, sr, u=u[v])
                    for v, lf in enumerate(lfs)]
        rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
        counts = torch.empty((V, H, W, 2), dtype=torch.int32, device=dev)
        sync()
        P.reset_launch_counts()
        image, steps = P.march_diff_fwd(vol, tf, rays, cfg, sr,
                                        counts=counts)
        sync()
        n = P.launch_counts()
        require(n["march_diff_fwd"] == 1 and n["march_diff_fwd.views"] == V,
                f"{label}: launches {n}")
        one = torch.empty((H, W, 2), dtype=torch.int32, device=dev)
        for v, r in enumerate(per_view):
            want = P.march_diff_fwd(vol, tf, r, cfg, sr, counts=one)
            require(torch.equal(image[v], want[0])
                    and torch.equal(steps[v], want[1])
                    and torch.equal(counts[v], one),
                    f"{label}: K1's view {v} in the batch is not its own "
                    f"launch's")

        with torch.no_grad():
            gts = rc.raycast_nondiff(job.vol_gt, job.tf, lfs,
                                     float(cfg_v["gt_sampling_rate"]))
        tf_rows = job.tf[None].repeat(V, 1, 1)

        def step(batched):
            v = job.vol.detach().clone().requires_grad_(True)
            t = (job.tf if batched else tf_rows).clone().requires_grad_(True)
            imgs = rc(v, t, lfs, u=u)
            P.dssim_mse_loss(imgs, gts).backward()
            return imgs.detach(), v.grad, (t.grad if batched
                                           else t.grad.sum(0))

        readings = {}
        for batched in (True, False):
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            P.reset_launch_counts()
            res = step(batched)
            sync()
            readings[batched] = (res, P.launch_counts(),
                                 torch.cuda.max_memory_allocated(dev) - base)
        (img_b, dv_b, dt_b), n_b, peak_b = readings[True]
        (img_l, dv_l, dt_l), n_l, peak_l = readings[False]
        require(n_b["march_diff_fwd"] == 1 and n_b["march_diff_bwd"] == V
                and n_b["march_diff_fwd.views"] == V
                and n_l["march_diff_fwd"] == V and n_l["march_diff_bwd"] == V
                and n_l["march_diff_fwd.views"] == 0,
                f"{label}: the batched step launched {n_b}, the loop {n_l}")
        require(torch.equal(img_b, img_l),
                f"{label}: the batched step's images are not the loop's")
        errs = {}
        for what, g, w in (("d_volume", dv_b, dv_l), ("d_tf", dt_b, dt_l)):
            m = float(w.abs().max())
            e = float((g - w).abs().max())
            require(bool(torch.isfinite(g).all()) and m > 0
                    and e <= K2_GRAD_TOL * m,
                    f"{label} {what}: max |diff| {e} > {K2_GRAD_TOL} * {m}")
            errs[what] = e / m
        k1_ms = cuda_ms_in_turn(
            dev, lambda: P.march_diff_fwd(vol, tf, rays, cfg, sr),
            lambda: [P.march_diff_fwd(vol, tf, r, cfg, sr)
                     for r in per_view])
        step_ms = cuda_ms_in_turn(dev, lambda: step(True),
                                  lambda: step(False), reps=5)
        out[scene] = {
            "views": V, "image": [H, W], "sampling_rate": sr,
            "launches": {"batched": n_b, "looped": n_l},
            "marched": int((steps - 1).sum()),
            "zero_skipped": int(counts[..., 0].sum()),
            "grad_rel_err": errs,
            "k1_ms": {"batched": k1_ms[0], "looped": k1_ms[1]},
            "step_ms": {"batched": step_ms[0], "looped": step_ms[1]},
            "step_peak_bytes": {"batched": peak_b, "looped": peak_l}}
        del job, vol, tf, rays, per_view, image, steps, counts, gts
        del readings, img_b, dv_b, dt_b, img_l, dv_l, dt_l
        torch.cuda.empty_cache()
    return out


def tf_only_k2(P, dev, res: int = 256) -> dict:
    """K2's TF-only instantiation at the shapes of the upstream TF fit: a
    ``res``^3 CT phantom, R 128, sampling rate 2, 2048 samples, the rays of
    the port example's camera at 240^2, with parity and with analytic
    normals, under tf5 as it is (its zero-alpha texels leave the air's
    samples quiet) and under the fit's black start (every sample lit until
    ERT).  On each block of TF_ONLY_TILE^2 rays of a checkerboard over the
    image, K1 then ``march_diff_bwd(..., volume_grad=False)`` against
    ``march_diff_bwd_plain`` (its TF terms summed in float64,
    :func:`tf_sums_in_f64`), for a seeded cotangent that is 0 on the rays
    K2 and the plain march end apart (the ERT knife edge, at most 0.1% of
    them).  The blocks' d_tf summed, held to TF_ONLY_TOL of the plain's
    largest texel; ``d_volume`` None; each call one K2 launch, tallied as
    ``march_diff_bwd.tf_only``.  Returns each case's relative error, knife-edge
    rays and launches."""
    import torch
    vol = P.volume_to_internal(torch.from_numpy(P.ct_phantom(res)).to(
        dev)).contiguous()
    look_from = torch.tensor([0.0, 0.9, 2.3], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    H = W = 240
    T = TF_ONLY_TILE
    blocks = [(slice(r, r + T), slice(c, c + T))
              for r in range(0, H, 2 * T) for c in range(0, W, 2 * T)]
    out = {}
    for analytic in (False, True):
        cfg = P.RenderConfig(volume_shape=tuple(vol.shape),
                             image_shape=(H, W), tf_resolution=128,
                             max_samples=2048, analytic_normals=analytic)
        rays = P.make_rays(look_from, cfg, 2.0)
        for name in ("tf5", "black"):
            label = f"TF-only K2, {name}, analytic={analytic}"
            tf = P.get_tf(name, 128, device=dev)
            g = torch.rand((H, W, 4), generator=gen, device=dev) - 0.5
            got = torch.zeros((128, 4), dtype=torch.float64, device=dev)
            want = torch.zeros_like(got)
            n_knife = launches = 0
            for blk in blocks:
                rays_b = rays._replace(
                    dirs=rays.dirs[blk], entry=rays.entry[blk],
                    exit=rays.exit[blk], n_samples=rays.n_samples[blk])
                cfg_b = cfg.replace(image_shape=(T, T))
                image_b, _ = P.march_diff_fwd(vol, tf, rays_b, cfg_b, 2.0)
                g_b = g[blk]
                for _ in range(2):      # again with the knife edge masked
                    torch.cuda.synchronize(dev)
                    P.reset_launch_counts()
                    d_volume, d_k, steps_k = P.march_diff_bwd(
                        vol, tf, rays_b, cfg_b, 2.0, image_b, g_b,
                        volume_grad=False)
                    torch.cuda.synchronize(dev)
                    c = P.launch_counts()
                    n = (c["march_diff_bwd"], c["march_diff_bwd.tf_only"])
                    require(d_volume is None and n == (1, 1),
                            f"{label}: d_volume {type(d_volume)}, "
                            f"launches {n}")
                    launches += 1
                    with tf_sums_in_f64(P):
                        _, d_p, steps_p = P.march_diff_bwd_plain(
                            vol, tf, rays_b, cfg_b, 2.0, g_b)
                    agree = steps_k == steps_p
                    if bool(agree.all()):
                        break
                    g_b = g_b * agree[..., None]
                n_knife += int((~agree).sum())
                got += d_k.double()
                want += d_p.double()
            m = float(want.abs().max())
            out[f"{name}_{'analytic' if analytic else 'parity'}"] = {
                "d_tf_rel_err": float((got - want).abs().max()) / m
                if m > 0 else math.inf,
                "finite": bool(torch.isfinite(got).all()),
                "knife_edge_rays": n_knife,
                "zero_alpha_texels": int((tf[:, 3] == 0).sum()),
                "launches": launches}
    for case in out.values():           # every case read before any fails
        require(case["knife_edge_rays"] <= 0.001 * len(blocks) * T * T
                and case["finite"] and case["d_tf_rel_err"] <= TF_ONLY_TOL,
                f"TF-only K2 against the plain march: {out}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    import differender_tpu_torch as P
    from differender_tpu_torch import _build
    from differender_tpu_torch.render import (march_diff_cotangents_plain,
                                              ray_sums)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, reps, warm=2, per_pair=1):
        """Device time of one call of ``fn`` by CUDA events, after ``warm``:
        the median over ``reps`` event pairs, each around ``per_pair`` calls
        and divided by them.  Many calls per pair keep the device queue ahead
        of the host, so a short kernel's time is not its enqueue time."""
        for _ in range(warm):
            fn()
        sync()
        pairs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per_pair):
                fn()
            b.record()
            pairs.append((a, b))
        sync()
        return statistics.median(a.elapsed_time(b) / per_pair
                                 for a, b in pairs)

    def cuda_ms_ab(fa, fb, reps, warm=10):
        """Device times of one call of ``fa`` and of ``fb`` by CUDA events,
        the two called in turn (``warm`` times each first): the medians over
        ``reps`` event pairs each, so that the card's clock drifts hit
        both."""
        for _ in range(warm):
            fa()
            fb()
        sync()
        pairs = ([], [])
        for _ in range(reps):
            for fn, out in zip((fa, fb), pairs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                out.append((a, b))
        sync()
        return tuple(statistics.median(a.elapsed_time(b) for a, b in out)
                     for out in pairs)

    def host_ms(fn, reps, warm=1):
        """Median host time of ``fn`` ending in a synchronize."""
        for _ in range(warm):
            fn()
        sync()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    def host_ms_ab(fa, fb, reps, warm=1):
        """Median host times of ``fa`` and ``fb``, each ending in a
        synchronize, called in turn so that the host's drifts hit both."""
        for _ in range(warm):
            fa()
            fb()
        sync()
        ts = ([], [])
        for _ in range(reps):
            for fn, out in zip((fa, fb), ts):
                t = time.perf_counter()
                fn()
                sync()
                out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts[0]), statistics.median(ts[1])

    def timed_once(fn):
        """``fn()`` and its device time by one pair of CUDA events."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        sync()
        return out, a.elapsed_time(b)

    def profile(fn, reps=3):
        """Device time by kernel over ``reps`` calls of ``fn``, per call,
        beside the wall time: where an entry point's time goes."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        fn()
        sync()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            wall = (time.perf_counter() - t) * 1e3 / reps
        kern = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        dev_ms = sum(ms for _, ms in kern)
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0) / reps
        return {"wall_ms": wall, "device_ms": dev_ms if kern else None,
                "busy_share": dev_ms / wall if kern else None,
                "host_gap_share": 1.0 - dev_ms / wall if kern else None,
                "n_kernels": len(kern), "launches": launches,
                "top": [[k[:60], ms] for k, ms in kern[:5]]}

    def launch_ms(call, reps=10, per_pair=20):
        """Device time of one call of a C entry (``call`` returns its
        ``cudaError_t``) by CUDA events around ``per_pair`` back-to-back
        calls: a ctypes call takes less host time than the kernels it
        launches, so the device queue stays ahead."""
        return cuda_ms(lambda: _build.check(call(), "launch_ms"), reps,
                       per_pair=per_pair)

    def device_kernels(fn, reps=5):
        """Per call of ``fn``, the launches and device time (ms) of each
        kernel, memset and copy it runs (torch.profiler), by name; tried
        three times while the profiler sees none, then {}."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        for _ in range(3):
            fn()
            sync()
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                sync()
            got = {e.key[:60]: {"launches": e.count / reps,
                                "ms": e.self_device_time_total / 1e3 / reps}
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
            if got:
                return got
        return {}

    def minmax_pools(vol, cell):
        """K6's function in library calls: the volume padded by
        replication to whole windows, then F.max_pool3d of it (the max) and
        of its negation (the min)."""
        shape = [-(-s // cell) for s in vol.shape]
        pad = []
        for size, n_cells in zip(reversed(vol.shape), reversed(shape)):
            pad += [1, n_cells * cell - size + 1]
        v = F.pad(vol[None, None], pad, mode="replicate")
        return (-F.max_pool3d(-v, cell + 2, cell)[0, 0],
                F.max_pool3d(v, cell + 2, cell)[0, 0])

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = _build.build()
    _build.library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "build_s": info.seconds, "build_cached": info.cached,
          "library": os.path.relpath(info.path, ROOT),
          "ptxas": info.ptxas})

    def ptxas_of(src, names):
        """The ptxas report of each kernel of ``src`` whose mangled name
        holds one of ``names``."""
        out, cur = {}, None
        for ln in info.ptxas.get(src, []):
            if "Compiling entry function" in ln:
                cur = next((n for n in names if n in ln), None)
                key = ln.split("'")[1] if cur else None
            elif cur and ("Used" in ln or "spill" in ln):
                out.setdefault(key, []).append(ln)
        return out

    emit({"phase": "resources",
          "brick_sums": ptxas_of("bricks.cu", [
              "brick_bin_kernel", "tile_scan_kernel", "brick_tile_kernel",
              "brick_final_kernel"]),
          "brick_rows": ptxas_of("bricks.cu", [
              "row_owner_kernel", "row_chunk_kernel", "row_final_kernel"]),
          "cell_minmax": ptxas_of("bricks.cu", ["cell_minmax_kernel"]),
          "tf_lookup_bwd": ptxas_of("tf_lookup.cu", ["tf_lookup_bwd_kernel",
                                                     "tf_grad_sum_kernel"]),
          "march_diff_fwd": ptxas_of("march.cu", ["march_diff_fwd_kernel"]),
          "march_nondiff": ptxas_of("march.cu", ["march_nondiff_kernel"]),
          "march_diff_bwd": ptxas_of("march_bwd.cu",
                                     ["march_diff_bwd_kernel"]),
          "shear_warp_fwd": ptxas_of("shear_warp.cu",
                                     ["shear_warp_fwd_kernel"]),
          "shear_warp_bwd": ptxas_of("shear_warp.cu",
                                     ["shear_warp_bwd_kernel"]),
          "ptxas_names": "template arguments <kGlobalTf, kAnalytic, "
                         "[kCamera, ]kSegment[, kVolumeGrad]> as Lb0/Lb1",
          "nvidia_smi": smi})

    kernels = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # The phases added with the backward draw from their own generator, so
    # the forward phases see the same data as before.
    gen_b = torch.Generator(device=dev)
    gen_b.manual_seed(1)
    gen_c = torch.Generator(device=dev)     # K2's 512^2 cotangents
    gen_c.manual_seed(2)

    # -- 2. K0 tf_lookup_fwd -------------------------------------------------
    n = 1 << 23
    inten = torch.rand(n, generator=gen, device=dev)
    inten[:5] = torch.tensor([-0.2, 0.0, 0.999999, 1.0, 1.3], device=dev)
    k0_launches, k0_err, k0 = 0, 0.0, None
    for R in (128, 4096):
        tf = torch.rand((R, 4), generator=gen, device=dev)
        P.reset_launch_counts()
        out = P.tf_lookup(tf, inten)
        sync()
        launches = P.launch_counts()["tf_lookup_fwd"]
        require(launches == 1, f"tf_lookup launched K0 {launches} times")
        require(out.shape == (n, 4) and bool(torch.isfinite(out).all()),
                "K0 output shape or finiteness")
        ref = P.tf_lookup_reference(tf, inten)
        err = float((out - ref).abs().max())
        require(err <= 1e-6, f"K0 max |diff| {err} > 1e-6 at R={R}")
        # K0 is shorter than the host's work per call: time it in runs of
        # 40 calls per event pair, and beside that by the profiler's device
        # time and by one call per event pair (which includes enqueue gaps).
        ms = cuda_ms(lambda: P.tf_lookup(tf, inten), 5, per_pair=40)
        profiler_ms = profile(lambda: P.tf_lookup(tf, inten), 40)["device_ms"]
        one_call_ms = cuda_ms(lambda: P.tf_lookup(tf, inten), 25)
        plain_ms = cuda_ms(lambda: P.tf_lookup_reference(tf, inten), 5,
                           per_pair=10)
        tex = tf.t().reshape(1, 4, 1, R).contiguous()
        grid = torch.stack([inten * 2.0 - 1.0, torch.zeros_like(inten)],
                           -1).reshape(1, 1, n, 2)

        def lib():
            return F.grid_sample(tex, grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        lib_err = float((lib()[0, :, 0].t() - ref).abs().max())
        library_ms = cuda_ms(lib, 5, per_pair=40)
        b_ms, b_by = bound(n * 4 + R * 16 + n * 16, n * TF_LOOKUP_OPS)
        emit({"phase": "tf_lookup_fwd", "R": R, "n": n,
              "launches": launches, "max_abs_err": err, "ms": ms,
              "profiler_ms": profiler_ms, "one_call_event_ms": one_call_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_max_abs_diff": lib_err, "bound_ms": b_ms,
              "bound_by": b_by, "nvidia_smi": smi})
        k0_launches += launches
        k0_err = max(k0_err, err)
        if R == 128:
            k0 = dict(ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms,
                      library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    kernels["tf_lookup_fwd"] = dict(
        route="cuda", source="differender_tpu_torch/csrc/tf_lookup.cu",
        replaces="differender_tpu/ops/tf_lookup.py:66",
        launches=k0_launches, max_abs_err=k0_err, **k0)

    # -- 2b. K0b tf_lookup_bwd ------------------------------------------------
    cot = torch.rand((n, 4), generator=gen_b, device=dev) - 0.5
    k0b_launches, k0b_err, k0b_err_tf, k0b, k0b_ms = 0, 0.0, 0.0, None, {}
    # R = 16384 lies above K0b's shared-memory limit (14336): global atomics.
    for R in (128, 4096, 16384):
        tf = torch.rand((R, 4), generator=gen_b, device=dev)
        tf_leaf = tf.clone().requires_grad_()
        x_leaf = inten.clone().requires_grad_()
        P.reset_launch_counts()
        d_tf, d_x = torch.autograd.grad(P.tf_lookup(tf_leaf, x_leaf),
                                        (tf_leaf, x_leaf), cot)
        sync()
        launches = P.launch_counts()["tf_lookup_bwd"]
        require(launches == 1, f"tf_lookup's backward launched K0b "
                               f"{launches} times")
        require(bool(torch.isfinite(d_tf).all() & torch.isfinite(d_x).all()),
                "K0b gradients finite")
        ref_tf, ref_x = P.tf_lookup_bwd_reference(tf, inten, cot)
        err_x = float((d_x - ref_x).abs().max())
        scale = float(ref_tf.abs().max())
        err_tf = float((d_tf - ref_tf).abs().max())
        require(err_x <= 1e-5 and err_tf <= 1e-4 * scale,
                f"K0b at R={R}: d_intensity {err_x} > 1e-5 or d_tf {err_tf}"
                f" > 1e-4 * {scale}")
        ms = cuda_ms(lambda: P.tf_lookup_bwd(tf, inten, cot), 5, per_pair=40)
        profiler_ms = profile(lambda: P.tf_lookup_bwd(tf, inten, cot),
                              40)["device_ms"]
        plain_ms = cuda_ms(lambda: P.tf_lookup_bwd_reference(tf, inten, cot),
                           5, per_pair=10)
        tex = tf.t().reshape(1, 4, 1, R).contiguous().requires_grad_()
        grid = torch.stack([inten * 2.0 - 1.0, torch.zeros_like(inten)],
                           -1).reshape(1, 1, n, 2).requires_grad_()
        lib_cot = cot.t().reshape(1, 4, 1, n).contiguous()

        def lib():
            out = F.grid_sample(tex, grid, mode="bilinear",
                                padding_mode="border", align_corners=True)
            return torch.autograd.grad(out, (tex, grid), lib_cot)

        library_ms = cuda_ms(lib, 5, per_pair=10)
        b_ms, b_by = bound(n * 4 + n * 16 + R * 16 + n * 4 + R * 16,
                           n * TF_LOOKUP_BWD_OPS)
        emit({"phase": "tf_lookup_bwd", "R": R, "n": n,
              "launches": launches, "max_abs_err_d_intensity": err_x,
              "max_abs_err_d_tf": err_tf, "max_abs_d_tf": scale, "ms": ms,
              "profiler_ms": profiler_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library": "autograd.grad of F.grid_sample w.r.t. texture "
                         "and grid, forward included",
              "bound_ms": b_ms, "bound_by": b_by, "nvidia_smi": smi})
        k0b_launches += launches
        k0b_err = max(k0b_err, err_x)
        k0b_err_tf = max(k0b_err_tf, err_tf / scale)
        k0b_ms[f"R{R}"] = {"ms": ms, "profiler_ms": profiler_ms,
                           "library_ms": library_ms, "bound_ms": b_ms}
        if R == 128:
            k0b = dict(ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        del tf_leaf, x_leaf, d_tf, d_x, ref_tf, ref_x, tex, grid, lib_cot
    kernels["tf_lookup_bwd"] = dict(
        route="cuda", source="differender_tpu_torch/csrc/tf_lookup.cu",
        replaces="differender_tpu/ops/tf_lookup.py:72",
        launches=k0b_launches, max_abs_err=k0b_err,
        max_rel_err_d_tf=k0b_err_tf, by_R=k0b_ms, **k0b)
    del cot, inten

    # -- 3./4. K1 and K3 through the Raycaster ---------------------------------
    res, img, R = 256, 512, 128
    rc = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                     jitter=True, max_samples=512, seed=0)
    rc_off = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                         jitter=True, max_samples=512, seed=0,
                         occupancy_skip=False)
    cfg = rc.config
    tf_user = P.get_tf_torch_layout("tf1", R, device=dev)
    tf_i = P.tf_to_internal(tf_user).contiguous()
    lf = torch.tensor([1.2, 0.8, 2.0], device=dev)
    scenes = {"noise": lambda: P.noise_volume(res, seed=0),
              "ct_phantom": lambda: P.ct_phantom(res)}
    for name, src, replaces in (
            ("march_diff_fwd", "march.cu", "differender_tpu/render.py:395"),
            ("march_diff_bwd", "march_bwd.cu",
             "differender_tpu/render.py:395"),
            ("march_nondiff", "march.cu", "differender_tpu/render.py:642")):
        kernels[name] = dict(
            route="cuda", source=f"differender_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0.0, library_ms=None)
    kernels["march_diff_bwd"]["replaces_note"] = (
        "the XLA VJP of march_diff (march_vjp='ad'): no Pallas kernel")
    for name, src, replaces in (
            ("brick_sums", "bricks.cu", "experiments/exp_pallas_dma.py:41"),
            ("brick_rows", "bricks.cu", "experiments/exp_pallas_dma.py:72"),
            ("cell_minmax", "bricks.cu", "differender_tpu/occupancy.py:88"),
            ("cell_distance", "distance.cu",
             "differender_tpu/occupancy.py:144")):
        kernels[name] = dict(
            route="cuda", source=f"differender_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0.0)
    for name, src, note in (
            ("march_segment_fwd", "march.cu",
             "the local march of segment_render (sampling.py:124 "
             "trilinear_shard, :181 sample_with_gradient_shard): XLA, no "
             "Pallas kernel"),
            ("march_segment_bwd", "march_bwd.cu",
             "JAX's AD through segment_render (jax.checkpoint per block): "
             "XLA, no Pallas kernel")):
        kernels[name] = dict(
            route="cuda", source=f"differender_tpu_torch/csrc/{src}",
            replaces="differender_tpu/parallel/volume_sharding.py:133",
            replaces_note=note, launches=0, max_abs_err=0.0,
            library_ms=None)
    kernels["march_segment_bwd_camera"] = dict(
        route="cuda", source="differender_tpu_torch/csrc/march_bwd.cu",
        replaces="differender_tpu/parallel/volume_sharding.py:133",
        replaces_note="JAX's AD of segment_render in look_from (the rays "
                      "built outside the shard_map, volume_sharding.py:230): "
                      "XLA, no Pallas kernel",
        launches=0, max_abs_err=0.0, library_ms=None)
    kernels["cell_minmax"]["replaces_note"] = (
        "the reduce_window pair of _cell_minmax: XLA, no Pallas kernel")
    kernels["cell_distance"]["replaces_note"] = (
        "the dilation rounds of build_occupancy: XLA, no Pallas kernel")

    def record(name, scene, launches, max_err, k_ms, p_ms, b_ms, b_by):
        k = kernels[name]
        k["launches"] += launches
        k["max_abs_err"] = max(k["max_abs_err"], max_err)
        if scene == "noise":    # the bench scene is the one reported
            k.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    vol_bytes = res ** 3 * 4
    ray_bytes = img * img * (5 * 4 + 4)

    def image_check(name, got, want):
        err = (got - want).abs()
        frac_over = float((err > 2e-4).float().mean())
        max_err = float(err.max())
        require(frac_over <= 1e-3 and max_err <= 0.08,
                f"{name}: {frac_over:.5f} of pixels over 2e-4, max {max_err}")
        return max_err, frac_over, int((err > 2e-4).sum())

    def count_check(name, got, want):
        """Every ray's sample count within 1 of the plain version's."""
        diff = int((got - want).abs().max())
        require(diff <= 1, f"{name}: a ray differs by {diff} samples")
        return diff

    def cell_load_check(name, counts, plain_loads, vis, want_vis):
        """K3's cell loads on every ray against the plain march's count of
        changes of the centre cell, but on the rays whose visited counts
        differ (the ERT knife edge, at most 0.1% of them).  Returns the
        number of such rays."""
        same = vis == want_vis
        n_knife = int((~same).sum())
        require(n_knife <= 1e-3 * same.numel(),
                f"{name}: {n_knife} rays with other visited counts")
        bad = int(((counts[..., 0] != plain_loads) & same).sum())
        require(bad == 0, f"{name}: {bad} rays' cell loads differ from the "
                          f"plain march's count")
        return n_knife

    def k3_counts(counts, visited, composited, n_knife):
        """K3's per-ray counts, summed: cell loads, the voxels composited
        samples loaded beyond their cell, grid reads.  n_knife: the rays
        left out of cell_load_check, or None where it was not run."""
        loads, extra, reads = (int(counts[..., i].sum()) for i in range(3))
        return {"cell_loads": loads,
                "cell_loads_per_visited": loads / max(visited, 1),
                "extra_loads": extra,
                "extra_loads_per_composited": extra / max(composited, 1),
                "grid_reads": reads,
                "grid_reads_per_visited": reads / max(visited, 1),
                "cell_loads_equal_plain": n_knife is not None,
                "rays_other_visited_count": n_knife}

    def grid_jumps(grid):
        """Whether any cell lies at distance 2 or more: else K3 looks up
        nothing (it reads the field's largest value on the device)."""
        return int(grid.dist.max()) >= 2

    def grid_read_bytes(grid):
        """The distance field, if K3 reads it."""
        return grid.dist.numel() * 4 if grid_jumps(grid) else 0

    def lookups(grid, visited, composited):
        """K3's grid lookups: one before each sample that follows one that
        did not composite (within one per ray: the first sample has one, a
        ray's last has none after it); none without a jump in the grid."""
        return visited - composited if grid_jumps(grid) else 0

    def count_build(counts, what):
        """One K6 and one K7 launch per grid build."""
        require(counts["cell_minmax"] == 1 and counts["cell_distance"] == 1,
                f"{what} launched K6 {counts['cell_minmax']}x and K7 "
                f"{counts['cell_distance']}x")
        for name in ("cell_minmax", "cell_distance"):
            kernels[name]["launches"] += counts[name]

    def k2_grad_errs(got_pair, want_pair, label):
        """max |K2 - plain| / max |plain| of d_volume and d_tf, each held
        to K2_GRAD_TOL."""
        errs = []
        for got, want, what in zip(got_pair, want_pair,
                                   ("d_volume", "d_tf")):
            e = float((got - want).abs().max())
            m = float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and m > 0
                    and e <= K2_GRAD_TOL * m,
                    f"K2 {what} on {label}: max |diff| {e} > "
                    f"{K2_GRAD_TOL} * {m}")
            errs.append(e / m)
        return errs

    def knife_mask(steps_k, steps_p, label):
        """Rays that K1 and the plain march end at the same sample.  A ray
        on the ERT knife edge gets no cotangent in either backward."""
        agree = steps_k == steps_p
        n_knife = int((~agree).sum())
        require(n_knife <= 0.001 * agree.numel(),
                f"{n_knife} knife-edge rays on {label}")
        return agree, n_knife

    def kink_free(vol_i, tf_c, rays_b, cfg_b, chunk=32):
        """Rays none of whose samples of opacity > 0 lies within 1e-6 of a
        kink of the shading (sampling rate 1, no ERT): the diffuse term's
        max(n.l, 0) at n.l = 0 and min(1, light) at light = 1.  There the
        gradient takes all, half or none of a slope as the last ulp falls,
        and K2 and the plain march round n.l and the light apart.  Such
        rays get no cotangent, as rays on the ERT knife edge."""
        from differender_tpu_torch.shading import (opacity_correction, shade,
                                                   unit_normal)
        prm = P.march_params(rays_b)
        n = rays_b.n_samples.clamp(max=cfg_b.max_samples)
        ok = torch.ones(n.shape, dtype=torch.bool, device=dev)
        lamp = rays_b.origin + torch.tensor([0.0, 1.0, 0.0], device=dev)
        top = int(n.max())
        for s0 in range(0, top, chunk):
            s = torch.arange(s0, min(s0 + chunk, top), device=dev,
                             dtype=torch.float32)
            t = prm.t0[..., None] + s * prm.dt[..., None]
            pos = rays_b.origin + t[..., None] * rays_b.dirs[..., None, :]
            flat = pos.reshape(-1, 3)
            inten, grad = P.sampling.sample_with_gradient(
                vol_i, flat, cfg_b.normal_delta)
            rgba = P.sampling.apply_tf(tf_c, inten)
            dirs = rays_b.dirs[..., None, :].expand(pos.shape).reshape(-1, 3)
            light = shade(flat, grad, torch.ones_like(rgba), dirs,
                          rays_b.origin, 1.0, cfg_b, clamp_light=False)
            to_lamp = flat - lamp
            to_lamp = to_lamp / to_lamp.norm(dim=-1, keepdim=True)
            n_dot_l = (unit_normal(grad) * to_lamp).sum(-1)
            kink = (opacity_correction(rgba[:, 3], 1.0) > 0) & (
                ((light[:, 0] - 1.0).abs() <= 1e-6)
                | (((grad * grad).sum(-1) > 0) & (n_dot_l.abs() <= 1e-6)))
            ok &= ~(kink.reshape(pos.shape[:-1]) & (s < n[..., None])).any(-1)
        return ok

    def k2_vs_plain(vol_i, tf_c, rays_s, cfg_s, g_s, ert, label, sr=1.0):
        """K2 against autograd of the plain march for the cotangent g_s."""
        label = f"{label} ({cfg_s.image_shape}, ert={ert})"
        img_s, steps_s = P.march_diff_fwd(vol_i, tf_c, rays_s, cfg_s, sr,
                                          ert=ert)
        with torch.no_grad():
            _, steps_p = P.march_diff_plain(vol_i, tf_c, rays_s, cfg_s, sr,
                                            ert=ert)
        agree, n_knife = knife_mask(steps_s, steps_p, label)
        g_m = g_s * agree[..., None]
        got = P.march_diff_bwd(vol_i, tf_c, rays_s, cfg_s, sr, img_s, g_m,
                               ert=ert)[:2]
        want = P.march_diff_bwd_plain(vol_i, tf_c, rays_s, cfg_s, sr, g_m,
                                      ert=ert)[:2]
        return k2_grad_errs(got, want, label), n_knife, img_s, g_m

    def tile_of(rays_f, cfg_f, blk):
        """The rays of the image block ``blk`` (a pair of slices) as a
        bundle of their own, and its config."""
        rays_b = rays_f._replace(
            dirs=rays_f.dirs[blk], entry=rays_f.entry[blk],
            exit=rays_f.exit[blk], n_samples=rays_f.n_samples[blk])
        return rays_b, cfg_f.replace(image_shape=tuple(
            rays_b.n_samples.shape))

    def spread_tiles(n_samples, tile, kinds):
        """Blocks of tile x tile rays spread over the image, one for each
        of ``kinds``: "corner" and "edge" the corner tile and the other
        border tile whose share of rays meeting the volume box is nearest
        1/2 (silhouette tiles), each "centre" the next tile down the
        diagonal inside the border.  Returns the tiles' (row, column), the
        blocks and an (H, W, 1) mask that is 1 on them."""
        H, W = n_samples.shape
        nr, nc = H // tile, W // tile
        hit = (n_samples > 0).float()

        def off_half(rc):
            r, c = rc
            share = hit[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile]
            return abs(float(share.mean()) - 0.5)

        border = [(r, c) for r in range(nr) for c in range(nc)
                  if r in (0, nr - 1) or c in (0, nc - 1)]
        corners = [rc for rc in border
                   if rc[0] in (0, nr - 1) and rc[1] in (0, nc - 1)]
        pools = {"corner": corners,
                 "edge": [rc for rc in border if rc not in corners]}
        diagonal = iter((i, i) for i in range(1, min(nr, nc) - 1))
        picks = [next(diagonal) if k == "centre"
                 else min(pools[k], key=off_half) for k in kinds]
        mask = torch.zeros((H, W, 1), device=n_samples.device)
        blocks = []
        for r, c in picks:
            blk = (slice(r * tile, (r + 1) * tile),
                   slice(c * tile, (c + 1) * tile))
            mask[blk] = 1.0
            blocks.append(blk)
        return picks, blocks, mask

    def plain_bwd_tiled(vol_i, tf_c, rays_f, cfg_f, g_f, tile):
        """Autograd of the plain march (sampling rate 1) for the cotangent
        g_f, summed over tile x tile blocks of the same rays: rays are
        independent and the gradient is linear in the cotangent, so the
        blocks add up to the whole image's gradient in a fraction of its
        autograd memory.  A block whose cotangent is 0 is skipped."""
        H, W = cfg_f.image_shape
        d_v, d_t = torch.zeros_like(vol_i), torch.zeros_like(tf_c)
        for r in range(0, H, tile):
            for c in range(0, W, tile):
                blk = (slice(r, r + tile), slice(c, c + tile))
                if not bool(g_f[blk].any()):
                    continue            # a zero cotangent adds nothing
                rays_b, cfg_b = tile_of(rays_f, cfg_f, blk)
                dv_b, dt_b, _ = P.march_diff_bwd_plain(
                    vol_i, tf_c, rays_b, cfg_b, 1.0, g_f[blk])
                d_v += dv_b
                d_t += dt_b
        return d_v, d_t

    def stencil_voxels(rays_f, steps_f, cfg_f, stride=2, chunk=4096):
        """Distinct voxels of the 7-point stencil per sample
        (``stencil_footprint``) over K1's samples on every stride-th ray in
        each image direction: their mean, the largest and the samples
        counted."""
        prm = P.march_params(rays_f)
        sel = (slice(None, None, stride), slice(None, None, stride))
        dirs = rays_f.dirs[sel].reshape(-1, 3)
        t0, dt = prm.t0[sel].reshape(-1), prm.dt[sel].reshape(-1)
        n = (steps_f[sel] - 1).reshape(-1).long()
        total, count, top = 0, 0, 0
        for r0 in range(0, n.numel(), chunk):
            nn = n[r0:r0 + chunk]
            ray = torch.repeat_interleave(
                torch.arange(nn.numel(), device=dev), nn)
            if ray.numel() == 0:
                continue
            first = torch.cumsum(nn, 0) - nn
            s = (torch.arange(ray.numel(), device=dev) - first[ray]).float()
            t = t0[r0:][ray] + s * dt[r0:][ray]
            pos = rays_f.origin + t[:, None] * dirs[r0:][ray]
            fp = P.sampling.stencil_footprint(pos, cfg_f.volume_shape,
                                              cfg_f.normal_delta)
            per = torch.bincount(fp.sample, minlength=pos.shape[0])
            total += int(per.sum())
            count += per.numel()
            top = max(top, int(per.max()))
            del fp, pos, t, s, ray
        return total / max(count, 1), top, count

    for scene, make in scenes.items():
        vol_user = torch.from_numpy(make()).to(dev)[None]
        vol_i = P.volume_to_internal(vol_user[0]).contiguous()
        u = torch.rand((img, img), generator=gen, device=dev)

        # K1: the differentiable path.
        P.reset_launch_counts()
        out = rc.forward_with_aux(vol_user, tf_user, lf, u=u)
        sync()
        launches = P.launch_counts()["march_diff_fwd"]
        require(launches == 1, f"Raycaster.forward launched K1 {launches}x")
        require(out.image.shape == (4, img, img)
                and bool(torch.isfinite(out.image).all())
                and float(out.image.min()) >= 0.0
                and float(out.image[3].max()) <= 1.0,
                f"K1 image shape/range on {scene}")
        rays = P.make_rays(lf, cfg, 1.0, u=u)
        want, want_steps = P.march_diff_plain(vol_i, tf_i, rays, cfg, 1.0)
        max_err, frac_over, n_over = image_check(
            f"K1 {scene}", out.image.permute(1, 2, 0), want)
        steps_diff = count_check(f"K1 {scene} valid_steps", out.valid_steps,
                                 want_steps)
        samples = int((out.valid_steps - 1).sum())
        # Without ERT there is no knife edge: every pixel within 2e-4.
        got_ne, steps_ne = P.march_diff(vol_i, tf_i, rays, cfg, 1.0,
                                        ert=False)
        want_ne, want_steps_ne = P.march_diff_plain(vol_i, tf_i, rays, cfg,
                                                    1.0, ert=False)
        noert_err = float((got_ne - want_ne).abs().max())
        require(noert_err <= 2e-4 and bool((steps_ne == want_steps_ne).all()),
                f"K1 {scene} without ERT: max |diff| {noert_err}")
        # K1's own counts on the same rays: the samples of opacity 0 that it
        # composited without their gradient, and those of the stencil's
        # general branch; the footprint of its samples.
        k1_counts = torch.zeros((img, img, 2), dtype=torch.int32, device=dev)
        image_c, _ = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0,
                                      counts=k1_counts)
        require(torch.equal(image_c, out.image.permute(1, 2, 0)),
                f"K1 with counts differs from Raycaster.forward on {scene}")
        n_skipped = int(k1_counts[..., 0].sum())
        n_general = int(k1_counts[..., 1].sum())
        vox_mean, vox_max, vox_n = stencil_voxels(rays, out.valid_steps, cfg)
        del image_c, k1_counts
        fwd_ms = host_ms(lambda: rc.forward(vol_user, tf_user, lf, u=u), 7)
        k_ms = cuda_ms(lambda: P.march_diff(vol_i, tf_i, rays, cfg, 1.0), 10)
        p_ms = cuda_ms(lambda: P.march_diff_plain(vol_i, tf_i, rays, cfg,
                                                  1.0), 2, warm=0)
        k1_bytes = vol_bytes + R * 16 + ray_bytes + img * img * 20
        b_ms_uncorrected, _ = bound(k1_bytes, samples * DIFF_SAMPLE_OPS)
        b_ms, b_by = bound(k1_bytes,
                           (samples - n_skipped) * DIFF_SAMPLE_OPS
                           + n_skipped * ZERO_OPACITY_OPS)
        emit({"phase": "march_diff_fwd", "scene": scene, "image": img,
              "launches": launches, "max_abs_err": max_err,
              "pixels_over_2e-4": n_over, "frac_over_2e-4": frac_over,
              "valid_steps_max_diff": steps_diff,
              "noert_max_abs_err": noert_err, "samples": samples,
              "samples_zero_opacity_skipped": n_skipped,
              "skip_share": n_skipped / max(samples, 1),
              "samples_general_branch": n_general,
              "stencil_voxels_per_sample": vox_mean,
              "stencil_voxels_max": vox_max,
              "stencil_voxels_samples_counted": vox_n,
              "forward_ms": fwd_ms, "ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_uncorrected": b_ms_uncorrected,
              "ptxas": [ln for ln in info.ptxas.get("march.cu", [])
                        if "Used" in ln or "spill" in ln],
              "nvidia_smi": smi})
        record("march_diff_fwd", scene, launches, max_err, k_ms, p_ms, b_ms,
               b_by)
        if scene == "noise":
            kernels["march_diff_fwd"]["bound_ms_uncorrected"] = \
                b_ms_uncorrected

        # K2: the gradient step, forward and backward through the Raycaster.
        v_leaf = vol_user.clone().requires_grad_()
        t_leaf = tf_user.clone().requires_grad_()

        def grad_step():
            v_leaf.grad = t_leaf.grad = None
            img_ = rc.forward(v_leaf, t_leaf, lf, u=u)
            img_.square().mean().backward()
            return img_

        P.reset_launch_counts()
        img_g = grad_step()
        sync()
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 1
                and counts["march_diff_bwd"] == 1,
                f"a gradient step launched K1 {counts['march_diff_fwd']}x "
                f"and K2 {counts['march_diff_bwd']}x on {scene}")
        launches = counts["march_diff_bwd"]
        require(bool(torch.isfinite(v_leaf.grad).all()
                     & torch.isfinite(t_leaf.grad).all()),
                f"K2 gradients finite on {scene}")
        # The same step by the wrappers: K2's own per-ray counts against
        # K1's, and its gradients against the Raycaster's.
        rays = P.make_rays(lf, cfg, 1.0, u=u)
        image, steps = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0)
        require(torch.equal(image, img_g.detach().permute(1, 2, 0)),
                f"K1 image differs between two calls on {scene}")
        g_img = 2.0 * image / image.numel()
        d_v, d_t, steps_bwd = P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0,
                                               image, g_img)
        sync()
        require(torch.equal(steps_bwd, steps),
                f"K2's per-ray counts differ from K1's on "
                f"{int((steps_bwd != steps).sum())} rays ({scene})")
        same_v = float((P.volume_from_internal(d_v) - v_leaf.grad[0])
                       .abs().max()) / float(d_v.abs().max())
        same_t = float((d_t.t() - t_leaf.grad).abs().max()) / float(
            d_t.abs().max())
        require(same_v <= 1e-4 and same_t <= 1e-4,
                f"K2 by the wrapper and by autograd differ: {same_v}, "
                f"{same_t} ({scene})")
        bwd_samples = int((steps_bwd - 1).sum())
        k2_counts = torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
        P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image, g_img,
                         counts=k2_counts)
        n_scattered, n_quiet_light, n_atomics, n_general_bwd = (
            int(k2_counts[..., i].sum()) for i in range(4))
        del k2_counts
        k2_ms = cuda_ms(lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0,
                                                 image, g_img), 10)
        step_ms = host_ms(grad_step, 7)
        k2_bytes = 3 * vol_bytes + R * 32 + ray_bytes + img * img * 36
        k2_ops = (n_scattered * BWD_SAMPLE_OPS
                  + (bwd_samples - n_scattered) * QUIET_SAMPLE_OPS)
        b_ms_uncorrected, _ = bound(k2_bytes, k2_ops)
        b_ms, b_by = bound(k2_bytes, k2_ops + n_quiet_light * QUIET_LIGHT_OPS)
        # K2 at the main path's own shape, ERT on, against autograd of the
        # plain march summed over 16 tiles of 128^2 rays (one 512^2 autograd
        # march would take tens of GB on ct_phantom), for a cotangent with
        # both signs.  The rays K1 ends elsewhere than the plain march (K1's
        # check above) get none.
        agree, n_knife_full = knife_mask(steps, want_steps,
                                         f"{scene} (512, 512)")
        g_full = (torch.rand((img, img, 4), generator=gen_c, device=dev)
                  - 0.3) * agree[..., None]
        got_full = P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image,
                                    g_full)[:2]
        sync()
        t_plain = time.perf_counter()
        want_full = plain_bwd_tiled(vol_i, tf_i, rays, cfg, g_full, 128)
        sync()
        plain_full_ms = (time.perf_counter() - t_plain) * 1e3
        full_errs = k2_grad_errs(got_full, want_full,
                                 f"{scene} (512, 512), ert=True")
        del got_full, want_full, g_full
        # Against autograd of the plain march at a 128^2 image: ERT off and
        # on, and on noise the TF-gradient rule of R > 1024 and an opaque TF.
        cfg_s = cfg.replace(image_shape=(128, 128))
        u_s = torch.rand((128, 128), generator=gen_b, device=dev)
        rays_s = P.make_rays(lf, cfg_s, 1.0, u=u_s)
        g_s = torch.rand((128, 128, 4), generator=gen_b, device=dev) - 0.3
        small = {}
        # normal_delta 6e-3 is 0.765 voxel at 256^3: most samples need both
        # extra layers of an axis and take the stencil's general branch.
        cfg_wide = cfg_s.replace(normal_delta=6e-3)
        cases = [("tf1", tf_i, False, cfg_s), ("tf1", tf_i, True, cfg_s),
                 ("tf1_delta6e-3", tf_i, False, cfg_wide),
                 ("tf1_delta6e-3", tf_i, True, cfg_wide)]
        if scene == "noise":
            # The TF-gradient rule of R > 1024 (K2's global-memory TF), and
            # a TF alpha of exactly 1 (K2's exact last sample, its restart
            # and its stop at T = 0).
            opaque = tf_i.clone()
            opaque[40:, 3] = 1.0
            cases += [("tf1_R2048", P.get_tf("tf1", 2048, device=dev), True,
                       cfg_s),
                      ("opaque", opaque, False, cfg_s),
                      ("opaque", opaque, True, cfg_s)]
        for label, tf_c, ert, cfg_c in cases:
            errs, n_knife, img_s, g_m = k2_vs_plain(vol_i, tf_c, rays_s,
                                                    cfg_c, g_s, ert,
                                                    f"{scene} {label}")
            small[f"{label}_ert_{ert}"] = {"rel_err_d_volume": errs[0],
                                          "rel_err_d_tf": errs[1],
                                          "knife_edge_rays": n_knife}
        # K1 and K2 in both branches of the stencil at delta 6e-3: K1
        # without ERT against the plain march, and each kernel's count of
        # general-branch samples.
        c1 = torch.zeros((128, 128, 2), dtype=torch.int32, device=dev)
        img_w, steps_w = P.march_diff_fwd(vol_i, tf_i, rays_s, cfg_wide, 1.0,
                                          ert=False, counts=c1)
        want_w, want_steps_w = P.march_diff_plain(vol_i, tf_i, rays_s,
                                                  cfg_wide, 1.0, ert=False)
        wide_err = float((img_w - want_w).abs().max())
        require(wide_err <= 2e-4 and torch.equal(steps_w, want_steps_w),
                f"K1 at delta 6e-3 on {scene} without ERT: max |diff| "
                f"{wide_err}")
        c2 = torch.zeros((128, 128, 4), dtype=torch.int32, device=dev)
        P.march_diff_bwd(vol_i, tf_i, rays_s, cfg_wide, 1.0, img_w, g_s,
                         ert=False, counts=c2)
        wide_samples = int((steps_w - 1).sum())
        wide_general = [int(c1[..., 1].sum()), int(c2[..., 3].sum())]
        # K2 recomputes K1's samples but stops once T is exactly 0.
        require(0 < wide_general[0] < wide_samples
                and 0 < wide_general[1] <= wide_general[0],
                f"delta 6e-3 on {scene}: {wide_general} of {wide_samples} "
                f"samples in the general branch (K1, K2)")
        wide = {"k1_noert_max_abs_err": wide_err, "samples": wide_samples,
                "general_branch_k1_k2": wide_general}
        del c1, c2, img_w, want_w
        img_s, _ = P.march_diff_fwd(vol_i, tf_i, rays_s, cfg_s, 1.0)
        g_m = g_s
        k2_small_ms = cuda_ms(lambda: P.march_diff_bwd(
            vol_i, tf_i, rays_s, cfg_s, 1.0, img_s, g_m), 10)
        plain_small_ms = cuda_ms(lambda: P.march_diff_bwd_plain(
            vol_i, tf_i, rays_s, cfg_s, 1.0, g_m), 1, warm=0)
        torch.cuda.empty_cache()
        k2_err = max(max(max(v["rel_err_d_volume"], v["rel_err_d_tf"])
                         for v in small.values()), *full_errs)
        emit({"phase": "march_diff_bwd", "scene": scene, "image": img,
              "launches": launches, "k1_launches": counts["march_diff_fwd"],
              "counts_equal_k1": True, "samples": bwd_samples,
              "samples_scattering": n_scattered,
              "samples_quiet_needing_light": n_quiet_light,
              "atomics": n_atomics,
              "atomics_per_scattering_sample":
                  n_atomics / max(n_scattered, 1),
              "samples_general_branch": n_general_bwd,
              "delta6e-3_128": wide,
              "wrapper_vs_autograd_rel": [same_v, same_t],
              "vs_plain_512_ert_True": {"rel_err_d_volume": full_errs[0],
                                        "rel_err_d_tf": full_errs[1],
                                        "knife_edge_rays": n_knife_full},
              "vs_plain_128": small, "tolerance": K2_GRAD_TOL,
              "ms": k2_ms, "grad_step_ms": step_ms,
              "plain_ms": plain_full_ms, "ms_128": k2_small_ms,
              "plain_ms_128": plain_small_ms,
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_uncorrected": b_ms_uncorrected,
              "ptxas": [ln for ln in info.ptxas.get("march_bwd.cu", [])
                        if "Used" in ln or "spill" in ln],
              "nvidia_smi": smi})
        k = kernels["march_diff_bwd"]
        k["launches"] += launches
        k["max_abs_err"] = max(k["max_abs_err"], k2_err)
        k["max_abs_err_is"] = "max |diff| / max |g| per gradient tensor"
        if scene == "noise":
            k.update(ms=k2_ms, plain_ms=plain_full_ms,
                     plain_ms_note="autograd of march_diff_plain over 16 "
                                   "tiles of 128^2, host clock",
                     bound_ms=b_ms, bound_by=b_by,
                     bound_ms_uncorrected=b_ms_uncorrected,
                     grad_step_ms=step_ms)
            grad_step_profile = profile(grad_step)
        del v_leaf, t_leaf, img_g, d_v, d_t, image, g_img

        # K3: the inference path, through the occupancy grid (K6).
        P.reset_launch_counts()
        nd = rc.raycast_nondiff(vol_user, tf_user, lf)
        sync()
        counts = P.launch_counts()
        launches = counts["march_nondiff"]
        require(launches == 1, f"raycast_nondiff launched K3 {launches}x")
        count_build(counts, "raycast_nondiff")
        require(nd.shape == (4, img, img) and bool(torch.isfinite(nd).all())
                and float(nd.min()) >= 0.0 and float(nd.max()) <= 1.0,
                f"K3 image shape/range on {scene}")
        sr = 4.0
        rays = P.make_rays(lf, cfg, sr)
        # Without the grid, against the plain march without it.
        loads_p = torch.zeros((img, img), dtype=torch.int32, device=dev)
        want, want_vis, want_comp = P.march_nondiff_plain(
            vol_i, tf_i, rays, cfg, sr, cell_loads=loads_p)
        max_err, frac_over, n_over = image_check(
            f"K3 {scene}", nd.permute(1, 2, 0), want)
        k3_n = torch.zeros((img, img, 3), dtype=torch.int32, device=dev)
        img_n, vis, comp = P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                           counts=k3_n)
        vis_diff = count_check(f"K3 {scene} visited", vis, want_vis)
        comp_diff = count_check(f"K3 {scene} composited", comp, want_comp)
        loads_n = cell_load_check(f"K3 {scene}", k3_n, loads_p, vis,
                                  want_vis)
        visited, composited = int(vis.sum()), int(comp.sum())
        # With the grid: bitwise K3 without it, and the plain march with it.
        grid = P.build_occupancy(vol_i, tf_i, cfg)
        k3_g = torch.zeros((img, img, 3), dtype=torch.int32, device=dev)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                               grid, counts=k3_g)
        sync()
        require(torch.equal(img_g, nd.permute(1, 2, 0)),
                f"K3 by the wrapper differs from raycast_nondiff on {scene}")
        require(torch.equal(img_g, img_n) and torch.equal(comp_g, comp),
                f"K3 with the grid differs from K3 without it on {scene}: "
                f"{int((img_g != img_n).any(-1).sum())} pixels, "
                f"{int((comp_g != comp).sum())} composited counts")
        (want_g, want_vis_g, want_comp_g), p_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg, sr, grid,
                                          cell_loads=loads_p))
        max_err_g, _, n_over_g = image_check(f"K3 {scene} with the grid",
                                             img_g, want_g)
        comp_diff_g = count_check(f"K3 {scene} composited with the grid",
                                  comp_g, want_comp_g)
        loads_g = cell_load_check(f"K3 {scene} with the grid", k3_g,
                                  loads_p, vis_g, want_vis_g)
        visited_g = int(vis_g.sum())
        fwd_ms, fwd_ms_no_grid = host_ms_ab(
            lambda: rc.raycast_nondiff(vol_user, tf_user, lf),
            lambda: rc_off.raycast_nondiff(vol_user, tf_user, lf), 9)
        k_ms = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                               grid), 10)
        k_ms_no_grid = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays,
                                                       cfg, sr), 10)
        p_ms_no_grid = cuda_ms(lambda: P.march_nondiff_plain(
            vol_i, tf_i, rays, cfg, sr), 1, warm=0)
        b_ms, b_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                           + ray_bytes + img * img * 24,
                           visited_g * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS
                           + lookups(grid, visited_g, composited) * JUMP_OPS)
        b_ms_no_grid, _ = bound(vol_bytes + R * 16 + ray_bytes
                                + img * img * 24,
                                visited * NONDIFF_VISIT_OPS
                                + composited * NONDIFF_SHADE_OPS)
        emit({"phase": "march_nondiff", "scene": scene, "image": img,
              "sampling_rate": sr, "launches": launches,
              "build_launches": [counts["cell_minmax"],
                                 counts["cell_distance"]],
              "max_abs_err": max_err, "pixels_over_2e-4": n_over,
              "frac_over_2e-4": frac_over, "visited_max_diff": vis_diff,
              "composited_max_diff": comp_diff,
              "grid": {"shape": grid.shape, "cell": grid.cell,
                       "jumps": grid_jumps(grid), "equal_to_no_grid": True,
                       "max_abs_err_vs_plain": max_err_g,
                       "pixels_over_2e-4_vs_plain": n_over_g,
                       "composited_max_diff_vs_plain": comp_diff_g},
              "samples_visited": visited_g,
              "samples_visited_no_grid": visited,
              "samples_composited": composited,
              "k3_counts": k3_counts(k3_g, visited_g, composited, loads_g),
              "k3_counts_no_grid": k3_counts(k3_n, visited, composited,
                                             loads_n),
              "raycast_ms": fwd_ms,
              "raycast_ms_no_grid": fwd_ms_no_grid, "ms": k_ms, "ms_no_grid": k_ms_no_grid, "plain_ms": p_ms,
              "plain_ms_no_grid": p_ms_no_grid, "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_no_grid": b_ms_no_grid, "nvidia_smi": smi})
        record("march_nondiff", scene, launches, max(max_err, max_err_g),
               k_ms, p_ms, b_ms, b_by)
        if scene == "noise":
            kernels["march_nondiff"]["ms_no_grid"] = k_ms_no_grid
            kernels["march_nondiff"]["cell_loads_per_visited"] = (
                int(k3_g[..., 0].sum()) / max(visited_g, 1))
        del grid, img_g, img_n, want, want_g, k3_n, k3_g, loads_p
        if scene == "noise":
            emit({"phase": "profile", "scene": scene,
                  "forward": profile(
                      lambda: rc.forward(vol_user, tf_user, lf, u=u)),
                  "grad_step": grad_step_profile,
                  "raycast_nondiff": profile(
                      lambda: rc.raycast_nondiff(vol_user, tf_user, lf)),
                  "raycast_nondiff_no_grid": profile(
                      lambda: rc_off.raycast_nondiff(vol_user, tf_user, lf)),
                  "nvidia_smi": smi})
        del vol_user, vol_i

    # -- 5b. train: volume fitting (examples/optimize_volume.py) ---------------
    clean = torch.from_numpy(P.ct_phantom(res)).to(dev)
    corrupt = torch.rand(clean.shape, generator=gen_b, device=dev) < 0.05
    start = torch.where(corrupt, torch.rand(clean.shape, generator=gen_b,
                                            device=dev), clean)
    views = torch.stack([P.in_circles(0.0, device=dev),
                         P.get_rand_pos(gen_b)])
    targets = rc.raycast_nondiff(clean[None, None].expand(2, 1, res, res, res),
                                 tf_user, views)
    v_fit = start[None].clone().requires_grad_()
    opt, sched = P.adamw_onecycle([v_fit], 0.05, 5)
    losses, step_times, grad_max = [], [], []
    P.reset_launch_counts()
    for _ in range(5):
        sync()
        t_step = time.perf_counter()
        opt.zero_grad()
        loss = P.dssim_mse_loss(
            rc(v_fit.expand(2, 1, res, res, res), tf_user, views), targets)
        loss.backward()
        opt.step()
        sched.step()
        P.project_unit(v_fit)
        sync()
        step_times.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(loss.detach()))
        grad_max.append(float(v_fit.grad.abs().max()))
        require(math.isfinite(losses[-1]) and math.isfinite(grad_max[-1]),
                f"train: non-finite loss or gradient {losses[-1]}, "
                f"{grad_max[-1]}")
    counts = P.launch_counts()
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    # One K1 launch a step for its 2 views of one volume (render_batch),
    # one K2 launch a view.
    require(counts["march_diff_fwd"] == 5 and counts["march_diff_bwd"] == 10
            and counts["march_diff_fwd.views"] == 10,
            f"train: 5 steps of 2 views launched {counts}")
    emit({"phase": "train", "volume": res, "image": img, "views": 2,
          "steps": 5, "loss": losses, "grad_abs_max": grad_max,
          "step_ms": step_times,
          "vol_l1_to_clean": [float((start - clean).abs().mean()),
                              float((v_fit.detach()[0] - clean).abs()
                                    .mean())],
          "launches": counts, "nvidia_smi": smi})
    del clean, corrupt, start, targets, v_fit, opt, sched

    # -- 6. golden fixtures ----------------------------------------------------
    golden = np.load(os.path.join(ROOT, "tests", "golden_renders.npz"))
    xs = [np.linspace(-1, 1, 32, dtype=np.float32)] * 3
    g = np.meshgrid(*xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    sphere = torch.from_numpy(
        (1.0 / (1.0 + np.exp(6.0 * (r - 0.6) * 8.0))).astype(np.float32)
    ).to(dev)
    gcfg = P.RenderConfig(volume_shape=(32, 32, 32), image_shape=(16, 16),
                          tf_resolution=32, max_samples=64)
    gtf = P.get_tf("tf1", 32, device=dev)
    glf = torch.tensor([1.2, 0.8, 2.0], device=dev)
    d_err = float(np.abs(P.render(sphere, gtf, glf, gcfg, 0.8).image.cpu()
                         .numpy() - golden["diff"]).max())
    n_err = float(np.abs(P.render_nondiff(sphere, gtf, glf, gcfg, 1.5).image
                         .cpu().numpy() - golden["nondiff"]).max())
    require(d_err <= 1e-4 and n_err <= 1e-4,
            f"golden fixtures: diff {d_err}, nondiff {n_err}")
    # K2 at the sphere's sampling rate 0.8 (opacity exponent 1.25; the bench
    # runs at 1), against the plain march and through value_and_grad_render.
    g_w = torch.rand((16, 16, 4), generator=gen_b, device=dev) - 0.3
    g_rays = P.make_rays(glf, gcfg, 0.8)
    sphere_grads = {}
    for ert in (False, True):
        errs, _, _, _ = k2_vs_plain(sphere, gtf, g_rays, gcfg, g_w, ert,
                                    "sphere", sr=0.8)
        P.reset_launch_counts()
        _, (dv_e, dt_e) = P.value_and_grad_render(
            sphere, gtf, glf, gcfg, lambda o: torch.sum(o.image * g_w), 0.8,
            ert=ert)
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 1
                and counts["march_diff_bwd"] == 1,
                f"value_and_grad_render launched {counts}")
        img_k, _ = P.march_diff_fwd(sphere, gtf, g_rays, gcfg, 0.8, ert=ert)
        dv_w, dt_w, _ = P.march_diff_bwd(sphere, gtf, g_rays, gcfg, 0.8,
                                         img_k, g_w, ert=ert)
        same = max(float((dv_e - dv_w).abs().max() / dv_w.abs().max()),
                   float((dt_e - dt_w).abs().max() / dt_w.abs().max()))
        require(same <= 1e-4, f"value_and_grad_render against K2: {same}")
        sphere_grads[f"ert_{ert}"] = {"rel_err_d_volume": errs[0],
                                      "rel_err_d_tf": errs[1],
                                      "value_and_grad_rel": same}
        k = kernels["march_diff_bwd"]
        k["max_abs_err"] = max(k["max_abs_err"], *errs)
    emit({"phase": "golden", "diff_max_abs_err": d_err,
          "nondiff_max_abs_err": n_err, "k2_sphere_sr0.8": sphere_grads})

    # -- 7. bricks: K4 and K5 on the TPU DMA probe's variants ------------------
    # experiments/exp_pallas_dma.py's sizes, and its draws in its order.
    V, B, n_b, NB = 256, 32, 2048, 4096
    rng = np.random.default_rng(0)
    vol_b = torch.from_numpy(rng.random((V, V, V), np.float32)).to(dev)
    al = rng.integers(0, (V - B) // 8, size=(n_b, 3)) * 8
    al[:, 2] = (al[:, 2] // 16) * 16
    un = rng.integers(0, V - B, size=(n_b, 3))
    table = torch.from_numpy(rng.random((NB, B, B * B), np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, NB, size=(n_b,))
                           .astype(np.int32)).to(dev)
    origins = {"A1_aligned": torch.from_numpy(al.astype(np.int32)).to(dev),
               "A2_unaligned": torch.from_numpy(un.astype(np.int32)).to(dev)}
    P.reset_launch_counts()
    outs = {k: P.brick_sums(vol_b, o) for k, o in origins.items()}
    outs["A3_bricked_rows"] = P.brick_rows(table, idx)
    sync()
    counts = P.launch_counts()
    require(counts["brick_sums"] == 2 and counts["brick_rows"] == 1,
            f"the probe's variants launched {counts}")
    lib = _build.library()
    dev_index = torch.cuda.current_device()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def same_bits(a, b):
        """Bitwise equality, NaN rows included."""
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def sums_check(label, got, want):
        """Every row within rtol 1e-5 of the plain version, lanes equal, NaN
        exactly where the plain version has NaN."""
        same = (got == got[:, :1]) | (got.isnan() & got[:, :1].isnan())
        require(got.shape == want.shape and bool(same.all()),
                f"{label}: shape {tuple(got.shape)} or lanes differ")
        nan = torch.isnan(want[:, 0])
        require(torch.equal(torch.isnan(got[:, 0]), nan),
                f"{label}: NaN rows differ from the plain version's")
        if bool(nan.all()):
            return 0.0, 0.0
        err = (got - want)[~nan].abs()
        rel = float((err / want[~nan].abs()).max())
        require(rel <= 1e-5, f"{label}: max relative error {rel} > 1e-5")
        return float(err.max()), rel

    def union_voxels(shape, o, b):
        """Voxels inside at least one b^3 brick at the origins o."""
        diff = torch.zeros([s + 1 for s in shape], dtype=torch.int32,
                           device=dev)
        o = o.long()
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    diff.index_put_(
                        (o[:, 0] + cx * b, o[:, 1] + cy * b, o[:, 2] + cz * b),
                        torch.full((o.shape[0],), (-1) ** (cx + cy + cz),
                                   dtype=torch.int32, device=dev),
                        accumulate=True)
        cover = diff.cumsum(0).cumsum(1).cumsum(2)[:shape[0], :shape[1],
                                                   :shape[2]]
        return int((cover > 0).sum())

    def k4_copied(vol, o):
        """What K4 reads by design: per tile the bounding box of its
        bricks' intersections (along z widened to multiples of 4 on the
        16-byte route), in voxels, and the (brick, tile) pairs."""
        plan = P.ops.bricks.k4_plan(vol.shape, o.shape[0])
        vec = vol.shape[2] % 4 == 0 and vol.data_ptr() % 16 == 0
        t = torch.tensor(P.ops.bricks.K4_TILE, device=dev)
        shape = torch.tensor(vol.shape, device=dev)
        o = o.long()
        o = o[((o >= 0) & (o <= shape - B)).all(1)]
        d = torch.stack(torch.meshgrid(*[torch.arange(s, device=dev)
                                         for s in plan.slots],
                                       indexing="ij"), -1).reshape(-1, 3)
        ti = (o // t)[:, None] + d[None]
        ok = (ti <= ((o + B - 1) // t)[:, None]).all(-1)
        ti, oo = ti[ok], o[:, None].expand(-1, d.shape[0], -1)[ok]
        org = ti * t
        lo = (oo - org).clamp(min=0)
        hi = torch.minimum(oo + B - org, torch.minimum(t, shape - org))
        tid = (ti[:, 0] * plan.tiles[1] + ti[:, 1]) * plan.tiles[2] + ti[:, 2]
        n_tiles = plan.tiles[0] * plan.tiles[1] * plan.tiles[2]
        at = tid[:, None].expand(-1, 3)
        b0 = torch.full((n_tiles, 3), 1 << 30, dtype=torch.long,
                        device=dev).scatter_reduce(0, at, lo, "amin")
        b1 = torch.zeros((n_tiles, 3), dtype=torch.long,
                         device=dev).scatter_reduce(0, at, hi, "amax")
        if vec:
            b0[:, 2] = b0[:, 2] // 4 * 4
            b1[:, 2] = (b1[:, 2] + 3) // 4 * 4
        used = torch.bincount(tid, minlength=n_tiles) > 0
        return int((b1 - b0)[used].prod(1).sum()), int(ok.sum())

    def k4_entry(vol, o):
        """K4's C entry on scratch and output allocated beforehand."""
        n = o.shape[0]
        plan = P.ops.bricks.k4_plan(vol.shape, n)
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                              device=dev)
        out = torch.empty((n, 128), device=dev)
        return out, lambda: lib.dr_brick_sums(
            vol.data_ptr(), *vol.shape, o.data_ptr(), n,
            scratch.data_ptr(), plan.scratch_words, out.data_ptr(),
            dev_index, stream())

    def k5_entry(tab, ix):
        """K5's C entry on scratch and output allocated beforehand."""
        n = ix.shape[0]
        plan = P.ops.bricks.k5_plan(tab.shape, n)
        scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                              device=dev)
        out = torch.empty((n, 128), device=dev)
        return out, lambda: lib.dr_brick_rows(
            tab.data_ptr(), tab.shape[0], tab.shape[1] * tab.shape[2],
            ix.data_ptr(), n, scratch.data_ptr(), plan.scratch_words,
            out.data_ptr(), dev_index, stream())

    def k4_case(label, vol, o, got=None, plain=True):
        """K4 against its plain version (rtol 1e-5, NaN rows), bitwise equal
        across wrapper calls and its C entry; the C entry's device time
        (CUDA events around 20 back-to-back calls) beside the wrapper's."""
        if got is None:
            got = P.brick_sums(vol, o)
        err, rel = sums_check(label, got, P.brick_sums_reference(vol, o))
        require(same_bits(P.brick_sums(vol, o), got),
                f"{label}: K4 differs between two calls")
        out, call = k4_entry(vol, o)
        ms = launch_ms(call)
        require(same_bits(out, got),
                f"{label}: K4's C entry differs from the wrapper's call")
        copied, pairs = k4_copied(vol, o)
        result = dict(n=o.shape[0], volume=list(vol.shape), max_abs_err=err,
                   max_rel_err=rel, ms=ms, ms_is=DEVICE_MS_IS,
                   wrapper_event_ms=cuda_ms(lambda: P.brick_sums(vol, o), 10,
                                            per_pair=10),
                   pairs=pairs, copied_bytes=copied * 4,
                   route="16-byte" if vol.shape[2] % 4 == 0
                   and vol.data_ptr() % 16 == 0 else "4-byte")
        if plain:
            result["plain_ms"] = cuda_ms(lambda: P.brick_sums_reference(vol, o),
                                      5)
        return result

    brick_bytes = B ** 3 * 4
    out_bytes = n_b * 128 * 4
    bricks_out = {}
    for label, o in origins.items():
        result = k4_case(label, vol_b, o, outs[label])
        # A brick partly or wholly outside the volume gives a NaN row.
        bad = torch.cat([o[:2], torch.tensor(
            [[V - B + 1, 0, 0], [0, -1, 0], [0, 0, V]], dtype=torch.int32,
            device=dev)])
        got_bad = P.brick_sums(vol_b, bad)
        require(torch.equal(got_bad[:2], outs[label][:2])
                and bool(torch.isnan(got_bad[2:]).all())
                and bool(torch.isnan(P.brick_sums_reference(vol_b, bad)[2:])
                         .all()),
                f"{label}: out-of-range origins do not give NaN rows")
        union = union_voxels(vol_b.shape, o, B)
        b_ms, b_by = bound(union * 4 + n_b * 12 + out_bytes, n_b * B ** 3)
        bricks_out[label] = dict(
            launches=1, **result, bound_ms=b_ms, bound_by=b_by,
            union_voxels=union,
            bound_ms_each_brick_from_hbm=bound(n_b * brick_bytes + out_bytes,
                                               0)[0],
            library_ms=None)
    # K4 at other sizes: 16 and 16384 unaligned origins (the plain version
    # at 16384 gathers 2 GiB), the 4-byte route on a 250x256x243 volume
    # (Z % 4 != 0) and on a base that is not 16-byte aligned, origins out
    # of range among the others.
    g_k4 = np.random.default_rng(7)
    k4_more = {}
    for n in (16, 16384):
        o = torch.from_numpy(g_k4.integers(0, V - B + 1, size=(n, 3))
                             .astype(np.int32)).to(dev)
        k4_more[f"n{n}"] = k4_case(f"K4 n={n}", vol_b, o)
    gen_k4 = torch.Generator(device=dev)
    gen_k4.manual_seed(3)
    odd = torch.rand((250, 256, 243), generator=gen_k4, device=dev)
    o = torch.from_numpy(np.concatenate([
        g_k4.integers(0, np.array(odd.shape) - B + 1, size=(2048, 3)),
        [[218, 224, 211], [219, 0, 0], [0, 0, 212], [-1, 5, 5]]])
        .astype(np.int32)).to(dev)
    k4_more["odd_250x256x243"] = k4_case("K4 on 250x256x243", odd, o)
    shifted = torch.empty(V ** 3 + 1, device=dev)[1:].view(V, V, V)
    shifted.copy_(vol_b)
    k4_more["unaligned_base"] = k4_case(
        "K4 on a base 4 bytes past 16-byte alignment", shifted,
        origins["A2_unaligned"], plain=False)
    require(torch.equal(P.brick_sums(shifted, origins["A2_unaligned"]),
                        outs["A2_unaligned"]),
            "K4's 4-byte route differs from its 16-byte route on one volume")
    del odd, shifted
    a2 = bricks_out["A2_unaligned"]
    ratio = k4_more["n16384"]["ms"] / a2["ms"]
    require(ratio < 16.0, f"K4 at n = 16384 takes {ratio:.2f}x its time at "
                          f"n = 2048: the binning is not linear")

    want = P.brick_rows_reference(table, idx)
    err, rel = sums_check("A3_bricked_rows", outs["A3_bricked_rows"], want)
    require(torch.equal(P.brick_rows(table, idx), outs["A3_bricked_rows"]),
            "A3: K5 differs between two calls")
    bad = torch.tensor([int(idx[0]), NB, -1], dtype=torch.int32, device=dev)
    got_bad = P.brick_rows(table, bad)
    require(torch.equal(got_bad[0], outs["A3_bricked_rows"][0])
            and bool(torch.isnan(got_bad[1:]).all()),
            "A3: indices out of range do not give NaN rows")
    out5, call5 = k5_entry(table, idx)
    ms = launch_ms(call5)
    require(torch.equal(out5, outs["A3_bricked_rows"]),
            "A3: K5's C entry differs from the wrapper's call")
    wrapper_ms = cuda_ms(lambda: P.brick_rows(table, idx), 10, per_pair=10)
    plain_ms = cuda_ms(lambda: P.brick_rows_reference(table, idx), 5)
    # K5 with every index equal, and duplicates among indices out of range.
    k5_more = {}
    g_k5 = np.random.default_rng(8)
    same = torch.full((n_b,), 17, dtype=torch.int32, device=dev)
    mixed = g_k5.integers(0, 64, size=n_b)
    mixed[::3] = NB + g_k5.integers(0, 5, size=mixed[::3].shape)
    mixed[1::7] = -1 - g_k5.integers(0, 5, size=mixed[1::7].shape)
    mixed = torch.from_numpy(mixed.astype(np.int32)).to(dev)
    for label, ix in (("all_equal", same), ("mixed_out_of_range", mixed)):
        got = P.brick_rows(table, ix)
        e5, r5 = sums_check(f"K5 {label}", got,
                            P.brick_rows_reference(table, ix))
        require(same_bits(P.brick_rows(table, ix), got),
                f"K5 {label}: differs between two calls")
        o5, c5 = k5_entry(table, ix)
        m5 = launch_ms(c5)
        require(same_bits(o5, got), f"K5 {label}: C entry differs")
        valid = ix[(ix >= 0) & (ix < NB)]
        k5_more[label] = dict(max_abs_err=e5, max_rel_err=r5, ms=m5,
                              distinct_bricks=int(torch.unique(valid).numel()),
                              nan_rows=int(torch.isnan(got[:, 0]).sum()))

    def lib_rows():
        return table.index_select(0, idx).sum((1, 2))

    lib_err = float((lib_rows() - want[:, 0]).abs().max())
    library_ms = cuda_ms(lib_rows, 5, per_pair=2)
    distinct = int(torch.unique(idx).numel())
    b_ms, b_by = bound(distinct * brick_bytes + n_b * 4 + out_bytes,
                       n_b * B ** 3)
    bricks_out["A3_bricked_rows"] = dict(
        launches=1, max_abs_err=err, max_rel_err=rel, ms=ms,
        ms_is=DEVICE_MS_IS, wrapper_event_ms=wrapper_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        distinct_bricks=distinct, read_bytes=distinct * brick_bytes,
        bound_ms_each_brick_from_hbm=bound(n_b * brick_bytes + out_bytes,
                                           0)[0],
        library_ms=library_ms,
        library="table.index_select(0, idx).sum((1, 2))",
        library_max_abs_diff=lib_err)
    emit({"phase": "bricks", "V": V, "B": B, "n": n_b, "NB": NB,
          "tolerance_rtol": 1e-5, "variants": bricks_out,
          "k4_more": k4_more, "k4_ms_ratio_16384_to_2048": ratio,
          "k5_more": k5_more, "bitwise_across_calls": True,
          "nvidia_smi": smi})
    kernels["brick_sums"].update(
        launches=counts["brick_sums"],
        max_abs_err=max(r["max_abs_err"] for r in
                        [bricks_out[k] for k in origins]
                        + list(k4_more.values())),
        max_rel_err=max(r["max_rel_err"] for r in
                        [bricks_out[k] for k in origins]
                        + list(k4_more.values())),
        ms=a2["ms"], ms_is=DEVICE_MS_IS,
        wrapper_event_ms=a2["wrapper_event_ms"],
        ms_A1_aligned=bricks_out["A1_aligned"]["ms"],
        ms_n16=k4_more["n16"]["ms"], ms_n16384=k4_more["n16384"]["ms"],
        plain_ms=a2["plain_ms"], bound_ms=a2["bound_ms"],
        bound_by=a2["bound_by"], library_ms=None,
        library_note="none: no single call gathers bricks at arbitrary "
                     "origins")
    a3 = bricks_out["A3_bricked_rows"]
    kernels["brick_rows"].update(
        launches=counts["brick_rows"],
        max_abs_err=max([a3["max_abs_err"]]
                        + [r["max_abs_err"] for r in k5_more.values()]),
        max_rel_err=max([a3["max_rel_err"]]
                        + [r["max_rel_err"] for r in k5_more.values()]),
        ms=a3["ms"], ms_is=DEVICE_MS_IS,
        wrapper_event_ms=a3["wrapper_event_ms"],
        plain_ms=a3["plain_ms"],
        bound_ms=a3["bound_ms"], bound_by=a3["bound_by"],
        library_ms=a3["library_ms"])
    del vol_b, table, idx, origins, outs, want, got_bad, out5, same, mixed
    torch.cuda.empty_cache()

    # -- 8. occupancy: K6, K7 and the grid's build ---------------------------
    tf_cpu = tf_i.cpu()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    for scene, make in scenes.items():
        vol_i = P.volume_to_internal(torch.from_numpy(make()).to(dev))
        vol_i = vol_i.contiguous()
        vol_cpu = vol_i.cpu()
        for cell_arg, md_arg in ((None, None), (8, 12)):
            cell, md = cfg.resolved_occupancy()
            if cell_arg is not None:
                cell, md = cell_arg, md_arg
            P.reset_launch_counts()
            grid = P.build_occupancy(vol_i, tf_i, cfg, cell_arg, md_arg)
            sync()
            count_build(P.launch_counts(), "build_occupancy")
            # The whole build on CPU copies runs the plain versions only.
            cpu = P.build_occupancy(vol_cpu, tf_cpu, cfg, cell_arg, md_arg)
            require(grid.shape == cpu.shape and grid.cell == cell
                    and grid.cell_world == cpu.cell_world
                    and torch.equal(grid.dist.cpu(), cpu.dist),
                    f"build_occupancy on the card differs from the CPU build "
                    f"on {scene} at cell {cell}")
            lo, hi = P.cell_minmax(vol_i, cell)
            lo_p, hi_p = P.cell_minmax_reference(vol_i, cell)
            require(torch.equal(lo, lo_p) and torch.equal(hi, hi_p),
                    f"K6 differs from its plain version on {scene} at cell "
                    f"{cell}")
            k7_args = (lo, hi, tf_i, cfg.alpha_skip, md)
            dist, far = P.cell_distance(*k7_args)
            dist_p, far_p = P.cell_distance_reference(*k7_args)
            require(torch.equal(dist, dist_p) and torch.equal(far, far_p)
                    and torch.equal(dist.reshape(-1), grid.dist)
                    and torch.equal(grid.far, far_p),
                    f"K7 differs from its plain version on {scene} at cell "
                    f"{cell}")
            # Device time by CUDA events around back-to-back calls of the C
            # entries: one call of a wrapper spends longer on the host than
            # K7 on the device, so events around wrapper calls time the
            # host, and the profiler does not always record these ctypes
            # launches.
            lo_t, hi_t = torch.empty_like(lo), torch.empty_like(hi)
            plan6 = P.ops.bricks.k6_plan(vol_i.shape, cell, sms)
            k6_dev_ms = launch_ms(lambda: lib.dr_cell_minmax(
                vol_i.data_ptr(), *vol_i.shape, cell, *plan6,
                lo_t.data_ptr(), hi_t.data_ptr(), dev_index, stream()))
            out7, tmp7 = torch.empty_like(dist), torch.empty_like(dist)
            far7 = torch.empty_like(far)
            k7_dev_ms = launch_ms(lambda: lib.dr_cell_distance(
                lo.data_ptr(), hi.data_ptr(), tf_i.data_ptr(), R,
                float(np.float32(cfg.alpha_skip)), *lo.shape, md,
                tmp7.data_ptr(), out7.data_ptr(), far7.data_ptr(), dev_index,
                stream()))
            require(torch.equal(lo_t, lo) and torch.equal(hi_t, hi)
                    and torch.equal(out7, dist) and torch.equal(far7, far),
                    f"K6/K7 by their C entries differ on {scene} at cell "
                    f"{cell}")
            # K7's texel groups at R = 4096 (its sparse table over groups of
            # 8 texels, the spans' ends from the TF).
            tf_big = P.get_tf("tf1", 4096, device=dev)
            big = (lo, hi, tf_big, cfg.alpha_skip, md)
            dist_b, far_b = P.cell_distance(*big)
            dist_bp, far_bp = P.cell_distance_reference(*big)
            require(torch.equal(dist_b, dist_bp)
                    and torch.equal(far_b, far_bp),
                    f"K7 at R = 4096 differs from its plain version on "
                    f"{scene} at cell {cell}")
            del tf_big, big, dist_b, dist_bp
            ms = cuda_ms(lambda: P.cell_minmax(vol_i, cell), 10, per_pair=5)
            plain_ms = cuda_ms(lambda: P.cell_minmax_reference(vol_i, cell), 5)
            lib_lo, lib_hi = minmax_pools(vol_i, cell)
            require(torch.equal(lib_lo, lo) and torch.equal(lib_hi, hi),
                    f"the max_pool3d pair differs from K6 on {scene} at cell "
                    f"{cell}")
            library_ms = cuda_ms(lambda: minmax_pools(vol_i, cell), 10,
                                 per_pair=5)
            lib_dev = device_kernels(lambda: minmax_pools(vol_i, cell))
            lib_dev_ms = sum(v["ms"] for v in lib_dev.values()) or None
            ms7 = cuda_ms(lambda: P.cell_distance(*k7_args), 10, per_pair=5)
            plain7 = cuda_ms(lambda: P.cell_distance_reference(*k7_args), 3)
            build_ms = host_ms(lambda: P.build_occupancy(
                vol_i, tf_i, cfg, cell_arg, md_arg), 7)
            build_dev_ms = cuda_ms(lambda: P.build_occupancy(
                vol_i, tf_i, cfg, cell_arg, md_arg), 7)
            n_cells = lo.numel()
            b_ms, b_by = bound(vol_bytes + 2 * n_cells * 4,
                               2 * n_cells * (cell + 2) ** 3)
            # K7 reads (lo, hi) and the TF and writes an int per cell and
            # the largest; its table takes R^2 / 2 maxima, the
            # classification 8 operations per cell (2 products, floor, ceil,
            # 4 clamps), and each of the three passes at least one
            # comparison per cell.
            b7_ms, b7_by = bound(n_cells * 12 + R * 16 + 4,
                                 R * R / 2 + n_cells * (8 + 3))
            emit({"phase": "occupancy", "scene": scene, "cell": cell,
                  "max_dist": md, "grid": grid.shape,
                  "minmax_equal": True, "distance_equal": True,
                  "equal_to_cpu_build": True,
                  "empty_share": float((grid.dist >= 2).float().mean()),
                  "cell_minmax": {"ms": ms, "device_ms": k6_dev_ms,
                                  "plain_ms": plain_ms,
                                  "library_ms": library_ms,
                                  "library_device_ms": lib_dev_ms,
                                  "bound_ms": b_ms, "bound_by": b_by},
                  "cell_distance": {"ms": k7_dev_ms, "event_ms": ms7,
                                    "plain_ms": plain7, "bound_ms": b7_ms,
                                    "bound_by": b7_by,
                                    "equal_at_R4096": True},
                  "build_ms": build_ms, "build_device_ms": build_dev_ms,
                  "nvidia_smi": smi})
            if scene == "ct_phantom" and cell_arg is None:
                kernels["cell_minmax"].update(
                    ms=k6_dev_ms, ms_is=DEVICE_MS_IS, wrapper_event_ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    build_ms=build_ms, library_ms=library_ms,
                    library_device_ms=lib_dev_ms,
                    library_note="two calls: F.max_pool3d of the "
                                 "replicate-padded volume and of its "
                                 "negation (the max and the min)")
                kernels["cell_distance"].update(
                    ms=k7_dev_ms, ms_is=DEVICE_MS_IS, wrapper_event_ms=ms7,
                    plain_ms=plain7, bound_ms=b7_ms,
                    bound_by=b7_by,
                    library_ms=None,
                    library_note="none: no single call gives a distance "
                                 "transform")
            if scene == "ct_phantom" and cell_arg is not None:
                kernels["cell_minmax"].update(
                    ms_cell8=k6_dev_ms, bound_ms_cell8=b_ms,
                    library_ms_cell8=library_ms)
            del grid, cpu, lo, hi, lo_p, hi_p, k7_args, dist, dist_p
        del vol_i, vol_cpu

    # K6 where the cell divides no side (the far faces clamp) and, at cell
    # 48, a tile's voxels are taken in bands: bitwise its plain version on
    # the card and the CPU build.
    odd = torch.rand((250, 256, 243), generator=gen_b, device=dev)
    odd_cpu = odd.cpu()
    P.reset_launch_counts()
    odd_cells = {}
    for cell in (2, 3, 8, 48):
        lo, hi = P.cell_minmax(odd, cell)
        lo_p, hi_p = P.cell_minmax_reference(odd, cell)
        lo_c, hi_c = P.cell_minmax(odd_cpu, cell)
        require(torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
                and torch.equal(lo.cpu(), lo_c)
                and torch.equal(hi.cpu(), hi_c),
                f"K6 on 250x256x243 at cell {cell} differs from its plain "
                f"version or the CPU build")
        odd_cells[cell] = {"grid": list(lo.shape), "equal": True,
                           "plan": list(P.ops.bricks.k6_plan(odd.shape, cell,
                                                             sms))}
    require(P.launch_counts()["cell_minmax"] == 4, "K6 launches on 250x256x243")
    emit({"phase": "occupancy_odd", "volume": [250, 256, 243],
          "cells": odd_cells, "nvidia_smi": smi})
    del odd, odd_cpu, lo, hi, lo_p, hi_p, lo_c, hi_c

    # -- 9. viewer: the inference example at full width ---------------------
    v_img, v_sr = 800, 16.0
    rc_v = P.Raycaster((res, res, res), (v_img, v_img), R, jitter=False)
    rc_v_off = P.Raycaster((res, res, res), (v_img, v_img), R, jitter=False,
                           occupancy_skip=False)
    cfg_v = rc_v.config
    lf_v = torch.tensor([0.0, 1.0, -2.3], device=dev)
    for scene, make in (("synthetic", lambda: P.synthetic_volume(res)),
                        ("ct_phantom", lambda: P.ct_phantom(res))):
        vol_user = torch.from_numpy(make()).to(dev)[None]
        vol_i = P.volume_to_internal(vol_user[0]).contiguous()
        P.reset_launch_counts()
        nd = rc_v.raycast_nondiff(vol_user, tf_user, lf_v, sampling_rate=v_sr)
        sync()
        counts = P.launch_counts()
        require(counts["march_nondiff"] == 1,
                f"the viewer's raycast_nondiff launched {counts}")
        count_build(counts, "the viewer's raycast_nondiff")
        kernels["march_nondiff"]["launches"] += counts["march_nondiff"]
        require(nd.shape == (4, v_img, v_img)
                and bool(torch.isfinite(nd).all())
                and float(nd.min()) >= 0.0 and float(nd.max()) <= 1.0,
                f"viewer image shape/range on {scene}")
        rays = P.make_rays(lf_v, cfg_v, v_sr)
        grid = P.build_occupancy(vol_i, tf_i, cfg_v)
        k3_g = torch.zeros((v_img, v_img, 3), dtype=torch.int32, device=dev)
        k3_n = torch.zeros_like(k3_g)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, grid, counts=k3_g)
        img_n, vis_n, comp_n = P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, counts=k3_n)
        sync()
        require(torch.equal(img_g, nd.permute(1, 2, 0)),
                f"viewer: K3 by the wrapper differs from raycast_nondiff on "
                f"{scene}")
        require(torch.equal(img_g, img_n) and torch.equal(comp_g, comp_n),
                f"viewer: K3 with the grid differs from K3 without it on "
                f"{scene}: {int((img_g != img_n).any(-1).sum())} pixels, "
                f"{int((comp_g != comp_n).sum())} composited counts")
        # K3 with the grid against the plain march with it, on the same
        # 800^2 rays.
        loads_p = torch.zeros((v_img, v_img), dtype=torch.int32, device=dev)
        (want, want_vis, want_comp), plain_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg_v, v_sr,
                                          grid, cell_loads=loads_p))
        max_err, frac_over, n_over = image_check(f"viewer {scene}", img_g,
                                                 want)
        comp_diff = count_check(f"viewer {scene} composited", comp_g,
                                want_comp)
        vis_diff = int((vis_g - want_vis).abs().max())
        n_knife = cell_load_check(f"viewer {scene}", k3_g, loads_p, vis_g,
                                  want_vis)
        raycast_ms, raycast_ms_no_grid = host_ms_ab(
            lambda: rc_v.raycast_nondiff(vol_user, tf_user, lf_v,
                                         sampling_rate=v_sr),
            lambda: rc_v_off.raycast_nondiff(vol_user, tf_user, lf_v,
                                             sampling_rate=v_sr), 5)
        k_ms = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, grid), 5)
        k_ms_no_grid = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays,
                                                       cfg_v, v_sr), 5)
        visited_g, visited_n = int(vis_g.sum()), int(vis_n.sum())
        composited = int(comp_g.sum())
        b_ms, b_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                           + v_img * v_img * 48,
                           visited_g * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS
                           + lookups(grid, visited_g, composited) * JUMP_OPS)
        emit({"phase": "viewer", "scene": scene, "image": v_img,
              "sampling_rate": v_sr, "camera": [0.0, 1.0, -2.3],
              "grid": {"shape": grid.shape, "cell": grid.cell},
              "launches": counts, "equal_to_no_grid": True,
              "samples_visited": visited_g,
              "samples_visited_no_grid": visited_n,
              "visited_ratio": visited_n / max(visited_g, 1),
              "samples_composited": composited,
              "k3_counts": k3_counts(k3_g, visited_g, composited, n_knife),
              "k3_counts_no_grid": k3_counts(k3_n, visited_n, composited,
                                             None),
              "max_n_samples": int(rays.n_samples.max()),
              "raycast_ms": raycast_ms,
              "raycast_ms_no_grid": raycast_ms_no_grid, "ms": k_ms,
              "ms_no_grid": k_ms_no_grid, "bound_ms": b_ms,
              "bound_by": b_by,
              "vs_plain": {"max_abs_err": max_err,
                           "pixels_over_2e-4": n_over,
                           "frac_over_2e-4": frac_over,
                           "composited_max_diff": comp_diff,
                           "visited_max_diff": vis_diff,
                           "plain_ms": plain_ms},
              "nvidia_smi": smi})
        kernels["march_nondiff"]["max_abs_err"] = max(
            kernels["march_nondiff"]["max_abs_err"], max_err)
        del vol_user, vol_i, grid, img_g, img_n, nd, want, want_vis
        del want_comp, k3_g, k3_n, loads_p
        torch.cuda.empty_cache()

    # -- 9b. analytic: the analytic normals at the bench workload ----------
    gen_a = torch.Generator(device=dev)
    gen_a.manual_seed(4)
    rc_a = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                       jitter=True, max_samples=512, seed=0,
                       analytic_normals=True)
    cfg_a = rc_a.config
    for scene, make in scenes.items():
        vol_user = torch.from_numpy(make()).to(dev)[None]
        vol_i = P.volume_to_internal(vol_user[0]).contiguous()
        u = torch.rand((img, img), generator=gen_a, device=dev)
        # K1 through the entry point, against the plain march.
        P.reset_launch_counts()
        out = rc_a.forward_with_aux(vol_user, tf_user, lf, u=u)
        sync()
        k1_launches = P.launch_counts()["march_diff_fwd"]
        require(k1_launches == 1,
                f"analytic Raycaster.forward launched K1 {k1_launches}x")
        rays = P.make_rays(lf, cfg_a, 1.0, u=u)
        (want, want_steps), k1_plain_ms = timed_once(
            lambda: P.march_diff_plain(vol_i, tf_i, rays, cfg_a, 1.0))
        k1_err, k1_frac, k1_over = image_check(
            f"analytic K1 {scene}", out.image.permute(1, 2, 0), want)
        count_check(f"analytic K1 {scene} valid_steps", out.valid_steps,
                    want_steps)
        got_ne, steps_ne = P.march_diff(vol_i, tf_i, rays, cfg_a, 1.0,
                                        ert=False)
        want_ne, want_steps_ne = P.march_diff_plain(vol_i, tf_i, rays,
                                                    cfg_a, 1.0, ert=False)
        k1_noert = float((got_ne - want_ne).abs().max())
        require(k1_noert <= 2e-4 and torch.equal(steps_ne, want_steps_ne),
                f"analytic K1 {scene} without ERT: max |diff| {k1_noert}")
        del got_ne, want_ne
        c1 = torch.zeros((img, img, 2), dtype=torch.int32, device=dev)
        image_a, steps_a = P.march_diff_fwd(vol_i, tf_i, rays, cfg_a, 1.0,
                                            counts=c1)
        require(torch.equal(image_a, out.image.permute(1, 2, 0))
                and int(c1[..., 1].sum()) == 0,
                f"analytic K1 on {scene}: counts call differs or "
                f"{int(c1[..., 1].sum())} general-branch samples")
        samples = int((steps_a - 1).sum())
        n_skipped = int(c1[..., 0].sum())
        del c1
        # A gradient step: one K1, one K2, no camera instantiation.
        v_leaf = vol_user.clone().requires_grad_()
        t_leaf = tf_user.clone().requires_grad_()

        def grad_step_a():
            v_leaf.grad = t_leaf.grad = None
            img_ = rc_a.forward(v_leaf, t_leaf, lf, u=u)
            img_.square().mean().backward()

        P.reset_launch_counts()
        grad_step_a()
        sync()
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 1
                and counts["march_diff_bwd"] == 1
                and counts["march_diff_bwd.camera"] == 0,
                f"analytic gradient step launched {counts}")
        k2_launches = counts["march_diff_bwd"]
        require(bool(torch.isfinite(v_leaf.grad).all()
                     & torch.isfinite(t_leaf.grad).all()),
                f"analytic K2 gradients finite on {scene}")
        k2c = torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
        g_img = 2.0 * image_a / image_a.numel()
        _, _, steps_b = P.march_diff_bwd(vol_i, tf_i, rays, cfg_a, 1.0,
                                         image_a, g_img, counts=k2c)
        require(torch.equal(steps_b, steps_a)
                and int(k2c[..., 3].sum()) == 0,
                f"analytic K2's counts differ from K1's on {scene}")
        n_scattered, n_quiet_light, n_atomics = (int(k2c[..., i].sum())
                                                 for i in range(3))
        del k2c
        agree, n_knife = knife_mask(steps_a, want_steps,
                                    f"analytic {scene} (512, 512)")
        # The cotangent on 4 of the 16 tiles of 128^2, 0 elsewhere: a
        # corner and an edge tile on the box's silhouette and two central
        # ones.  The plain march's autograd on the host is the longest part
        # of the command, and the parity check above covers every tile.
        a_tiles, _, a_mask = spread_tiles(
            rays.n_samples, 128, ("corner", "edge", "centre", "centre"))
        g_full = (torch.rand((img, img, 4), generator=gen_a, device=dev)
                  - 0.3) * agree[..., None] * a_mask
        got_full = P.march_diff_bwd(vol_i, tf_i, rays, cfg_a, 1.0, image_a,
                                    g_full)[:2]
        sync()
        t_plain = time.perf_counter()
        want_full = plain_bwd_tiled(vol_i, tf_i, rays, cfg_a, g_full, 128)
        sync()
        k2_plain_ms = (time.perf_counter() - t_plain) * 1e3
        k2_errs = k2_grad_errs(got_full, want_full,
                               f"analytic {scene} (512, 512), ert=True")
        del got_full, want_full, g_full
        # Times beside the parity instantiations, on the same rays, the two
        # called in turn after the plain march's long host work.
        k1_ms_a, k1_ms_p = cuda_ms_ab(
            lambda: P.march_diff(vol_i, tf_i, rays, cfg_a, 1.0),
            lambda: P.march_diff(vol_i, tf_i, rays, cfg, 1.0), 10, warm=25)
        image_p, _ = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0)
        g_p = 2.0 * image_p / image_p.numel()
        k2_ms_a, k2_ms_p = cuda_ms_ab(
            lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg_a, 1.0, image_a,
                                     g_img),
            lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image_p,
                                     g_p), 10)
        step_ms_a = host_ms(grad_step_a, 5)
        del v_leaf, t_leaf
        k1_bytes = vol_bytes + R * 16 + ray_bytes + img * img * 20
        b1_ms, b1_by = bound(k1_bytes,
                             (samples - n_skipped) * DIFF_SAMPLE_OPS_A
                             + n_skipped * ZERO_OPACITY_OPS)
        k2_bytes = 3 * vol_bytes + R * 32 + ray_bytes + img * img * 36
        b2_ms, b2_by = bound(k2_bytes, n_scattered * BWD_SAMPLE_OPS_A
                             + (samples - n_scattered) * QUIET_SAMPLE_OPS
                             + n_quiet_light * QUIET_LIGHT_OPS_A)
        # K3 through raycast_nondiff: the grid's build and one K3.
        P.reset_launch_counts()
        nd = rc_a.raycast_nondiff(vol_user, tf_user, lf)
        sync()
        counts = P.launch_counts()
        require(counts["march_nondiff"] == 1,
                f"analytic raycast_nondiff launched K3 "
                f"{counts['march_nondiff']}x")
        count_build(counts, "analytic raycast_nondiff")
        k3_launches = counts["march_nondiff"]
        sr = 4.0
        rays4 = P.make_rays(lf, cfg_a, sr)
        grid = P.build_occupancy(vol_i, tf_i, cfg_a)
        k3_g = torch.zeros((img, img, 3), dtype=torch.int32, device=dev)
        k3_n = torch.zeros_like(k3_g)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays4, cfg_a, sr,
                                               grid, counts=k3_g)
        img_n, vis_n, comp_n = P.march_nondiff(vol_i, tf_i, rays4, cfg_a, sr,
                                               counts=k3_n)
        sync()
        require(torch.equal(img_g, nd.permute(1, 2, 0))
                and torch.equal(img_g, img_n) and torch.equal(comp_g, comp_n),
                f"analytic K3 with the grid differs from K3 without it on "
                f"{scene}: {int((img_g != img_n).any(-1).sum())} pixels")
        extra = int(k3_g[..., 1].sum()) + int(k3_n[..., 1].sum())
        require(extra == 0, f"analytic K3 loaded {extra} voxels beyond its "
                            f"cell on {scene}")
        loads_p = torch.zeros((img, img), dtype=torch.int32, device=dev)
        (want3, want_vis, want_comp), k3_plain_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays4, cfg_a, sr,
                                          grid, cell_loads=loads_p))
        k3_err, _, k3_over = image_check(f"analytic K3 {scene}", img_g,
                                         want3)
        count_check(f"analytic K3 {scene} composited", comp_g, want_comp)
        k3_knife = cell_load_check(f"analytic K3 {scene}", k3_g, loads_p,
                                   vis_g, want_vis)
        k3_ms_a, k3_ms_p = cuda_ms_ab(
            lambda: P.march_nondiff(vol_i, tf_i, rays4, cfg_a, sr, grid),
            lambda: P.march_nondiff(vol_i, tf_i, rays4, cfg, sr, grid), 10)
        visited, composited = int(vis_g.sum()), int(comp_g.sum())
        b3_ms, b3_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                             + ray_bytes + img * img * 24,
                             visited * NONDIFF_VISIT_OPS
                             + composited * NONDIFF_SHADE_OPS_A
                             + lookups(grid, visited, composited) * JUMP_OPS)
        emit({"phase": "analytic", "scene": scene, "image": img,
              "march_diff_fwd": {
                  "launches": k1_launches, "max_abs_err": k1_err,
                  "pixels_over_2e-4": k1_over, "noert_max_abs_err": k1_noert,
                  "samples": samples, "samples_zero_opacity_skipped":
                      n_skipped, "samples_general_branch": 0,
                  "ms": k1_ms_a, "ms_parity": k1_ms_p,
                  "plain_ms": k1_plain_ms, "bound_ms": b1_ms,
                  "bound_by": b1_by},
              "march_diff_bwd": {
                  "launches": k2_launches, "camera": 0,
                  "counts_equal_k1": True,
                  "vs_plain_512_ert_True": {"rel_err_d_volume": k2_errs[0],
                                            "rel_err_d_tf": k2_errs[1],
                                            "knife_edge_rays": n_knife,
                                            "tiles_128": a_tiles},
                  "samples_scattering": n_scattered,
                  "samples_quiet_needing_light": n_quiet_light,
                  "atomics": n_atomics,
                  "atomics_per_scattering_sample":
                      n_atomics / max(n_scattered, 1),
                  "ms": k2_ms_a, "ms_parity": k2_ms_p,
                  "plain_ms": k2_plain_ms, "grad_step_ms": step_ms_a,
                  "bound_ms": b2_ms, "bound_by": b2_by},
              "march_nondiff": {
                  "launches": k3_launches, "sampling_rate": sr,
                  "grid_equal_to_no_grid": True,
                  "max_abs_err_vs_plain": k3_err,
                  "pixels_over_2e-4": k3_over, "extra_loads": extra,
                  "k3_counts": k3_counts(k3_g, visited, composited,
                                         k3_knife),
                  "ms": k3_ms_a, "ms_parity": k3_ms_p,
                  "plain_ms": k3_plain_ms, "bound_ms": b3_ms,
                  "bound_by": b3_by},
              "nvidia_smi": smi})
        for name, launches, err in (
                ("march_diff_fwd", k1_launches, k1_err),
                ("march_diff_bwd", k2_launches, max(k2_errs)),
                ("march_nondiff", k3_launches, k3_err)):
            kernels[name]["launches"] += launches
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               err)
        if scene == "noise":
            kernels["march_diff_fwd"].update(ms_analytic=k1_ms_a,
                                             bound_ms_analytic=b1_ms)
            kernels["march_diff_bwd"].update(ms_analytic=k2_ms_a,
                                             bound_ms_analytic=b2_ms)
            kernels["march_nondiff"].update(ms_analytic=k3_ms_a,
                                            bound_ms_analytic=b3_ms)
        del vol_user, vol_i, grid, img_g, img_n, want3, k3_g, k3_n, loads_p
        del image_a, image_p, g_img, g_p, want, nd
        torch.cuda.empty_cache()
    # K3 at the viewer workload in analytic mode: against the plain march on
    # all 800^2 rays, and timed beside parity.
    cfg_va = cfg_v.replace(analytic_normals=True)
    for scene, make in (("synthetic", lambda: P.synthetic_volume(res)),
                        ("ct_phantom", lambda: P.ct_phantom(res))):
        vol_i = P.volume_to_internal(torch.from_numpy(make()).to(dev))
        vol_i = vol_i.contiguous()
        rays = P.make_rays(lf_v, cfg_va, v_sr)
        grid = P.build_occupancy(vol_i, tf_i, cfg_va)
        k3_g = torch.zeros((v_img, v_img, 3), dtype=torch.int32, device=dev)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays, cfg_va,
                                               v_sr, grid, counts=k3_g)
        img_n, _, comp_n = P.march_nondiff(vol_i, tf_i, rays, cfg_va, v_sr)
        sync()
        require(torch.equal(img_g, img_n) and torch.equal(comp_g, comp_n)
                and int(k3_g[..., 1].sum()) == 0,
                f"analytic K3 at the viewer on {scene}: the grid changes the "
                f"image or K3 loaded beyond its cell")
        loads_p = torch.zeros((v_img, v_img), dtype=torch.int32, device=dev)
        (want, want_vis, want_comp), plain_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg_va, v_sr,
                                          grid, cell_loads=loads_p))
        max_err, frac_over, n_over = image_check(
            f"analytic viewer {scene}", img_g, want)
        comp_diff = count_check(f"analytic viewer {scene} composited",
                                comp_g, want_comp)
        n_knife = cell_load_check(f"analytic viewer {scene}", k3_g, loads_p,
                                  vis_g, want_vis)
        del want, want_vis, want_comp, loads_p
        ms_a, ms_p = cuda_ms_ab(
            lambda: P.march_nondiff(vol_i, tf_i, rays, cfg_va, v_sr, grid),
            lambda: P.march_nondiff(vol_i, tf_i, rays, cfg_v, v_sr, grid), 5)
        visited, composited = int(vis_g.sum()), int(comp_g.sum())
        b_ms, b_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                           + v_img * v_img * 48,
                           visited * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS_A
                           + lookups(grid, visited, composited) * JUMP_OPS)
        emit({"phase": "analytic_viewer", "scene": scene, "image": v_img,
              "sampling_rate": v_sr, "grid_equal_to_no_grid": True,
              "extra_loads": 0, "samples_visited": visited,
              "samples_composited": composited,
              "k3_counts": k3_counts(k3_g, visited, composited, n_knife),
              "vs_plain": {"max_abs_err": max_err,
                           "pixels_over_2e-4": n_over,
                           "frac_over_2e-4": frac_over,
                           "composited_max_diff": comp_diff,
                           "plain_ms": plain_ms},
              "ms": ms_a, "ms_parity": ms_p, "bound_ms": b_ms,
              "bound_by": b_by, "nvidia_smi": smi})
        kernels["march_nondiff"]["max_abs_err"] = max(
            kernels["march_nondiff"]["max_abs_err"], max_err)
        if scene == "ct_phantom":
            kernels["march_nondiff"]["ms_analytic_viewer"] = ms_a
        del vol_i, grid, img_g, img_n, k3_g
        torch.cuda.empty_cache()

    # -- 9c. camera: K2's camera instantiation and d_look_from -------------
    def leaves_of(rays_l):
        """Leaves for a ray bundle's origin, directions, entry and exit."""
        return [x.detach().clone().requires_grad_()
                for x in (rays_l.origin, rays_l.dirs, rays_l.entry,
                          rays_l.exit)]

    def with_leaves(rays_l, lv):
        return rays_l._replace(origin=lv[0], dirs=lv[1], entry=lv[2],
                               exit=lv[3])

    def camera_case(vol_i, tf_c, cfg_c, u_c, lf_c, g_c, sr, ert, label,
                    tile=128):
        """K2's camera instantiation against the plain march for the image
        cotangent g_c, in tiles of tile x tile rays (rays are independent):
        its 12 sums per ray against the plain per-sample cotangents summed
        per ray (P, S, L, V); the cotangents of the ray tensors of
        march_diff (K1, K2 and the wrapper's map) against autograd of the
        plain march in the same tensors, per ray (dirs, entry, exit) and
        per tile (origin); d_look_from of render against those plain
        cotangents pulled through the ray setup; its d_volume and d_tf
        against K2's default ones.  Rays on the ERT knife edge get no
        cotangent.  Returns the case's record and the plain d_look_from."""
        H, W = cfg_c.image_shape
        lf_p = lf_c.clone().requires_grad_()
        rays_p = P.make_rays(lf_p, cfg_c, sr, u=u_c)
        rays_c = type(rays_p)(*(x.detach() for x in rays_p))
        img_k, steps_k = P.march_diff_fwd(vol_i, tf_c, rays_c, cfg_c, sr,
                                          ert=ert)
        with torch.no_grad():
            _, steps_p = P.march_diff_plain(vol_i, tf_c, rays_c, cfg_c, sr,
                                            ert=ert)
        agree, n_knife = knife_mask(steps_k, steps_p, label)
        g_m = g_c * agree[..., None]
        sums = torch.zeros((H, W, 12), device=dev)
        P.reset_launch_counts()
        d_v, d_t, _ = P.march_diff_bwd(vol_i, tf_c, rays_c, cfg_c, sr, img_k,
                                       g_m, ert=ert, sums=sums)
        cam_launches = P.launch_counts()["march_diff_bwd.camera"]
        d_v0, d_t0, _ = P.march_diff_bwd(vol_i, tf_c, rays_c, cfg_c, sr,
                                         img_k, g_m, ert=ert)
        cam_after = P.launch_counts()["march_diff_bwd.camera"]
        require(cam_launches == 1 and cam_after == 1,
                f"camera {label}: {cam_after} camera launches")
        same = max(float((d_v - d_v0).abs().max() / d_v0.abs().max()),
                   float((d_t - d_t0).abs().max() / d_t0.abs().max()))
        require(same <= K2_GRAD_TOL, f"camera {label}: K2's camera "
                                     f"instantiation's gradients {same}")
        require(bool(torch.isfinite(sums).all()),
                f"camera {label}: K2's sums not finite")
        del d_v, d_v0, img_k
        lv = leaves_of(rays_c)
        img_l, _ = P.march_diff(vol_i, tf_c, with_leaves(rays_c, lv), cfg_c,
                                sr, ert=ert)
        got = torch.autograd.grad(img_l, lv, g_m)
        want = [torch.zeros_like(x) for x in got]
        sum_err, sum_max = [0.0] * 4, [0.0] * 4
        o_err = o_max = 0.0
        for r in range(0, H, tile):
            for c in range(0, W, tile):
                blk = (slice(r, r + tile), slice(c, c + tile))
                rays_b = rays_c._replace(
                    dirs=rays_c.dirs[blk], entry=rays_c.entry[blk],
                    exit=rays_c.exit[blk], n_samples=rays_c.n_samples[blk])
                cfg_b = cfg_c.replace(image_shape=tuple(
                    rays_b.n_samples.shape))
                ref = ray_sums(march_diff_cotangents_plain(
                    vol_i, tf_c, rays_b, cfg_b, sr, g_m[blk], ert=ert),
                    cfg_b.image_shape)
                s_b = sums[blk]
                for k in range(4):
                    cols = slice(3 * k, 3 * k + 3)
                    sum_err[k] = max(sum_err[k], float(
                        (s_b[..., cols] - ref[..., cols]).abs().max()))
                    sum_max[k] = max(sum_max[k],
                                     float(ref[..., cols].abs().max()))
                lb = leaves_of(rays_b)
                img_b, _ = P.march_diff_plain(vol_i, tf_c,
                                              with_leaves(rays_b, lb), cfg_b,
                                              sr, ert=ert)
                gb = torch.autograd.grad(img_b, lb, g_m[blk])
                want[0] += gb[0]
                for k in (1, 2, 3):
                    want[k][blk] = gb[k]
                # The tile's origin cotangent from K2's sums: sum (P - L).
                o_k = (s_b[..., 0:3] - s_b[..., 6:9]).sum((0, 1))
                o_err = max(o_err, float((o_k - gb[0]).abs().max()))
                o_max = max(o_max, float(gb[0].abs().max()))
                del ref, img_b, gb
        errs = []
        for k, what in enumerate("PSLV"):
            require(sum_max[k] > 0 and sum_err[k] <= CAMERA_SUM_TOL
                    * sum_max[k],
                    f"camera {label}: K2's {what} per ray, max |diff| "
                    f"{sum_err[k]} > {CAMERA_SUM_TOL} * {sum_max[k]}")
            errs.append(sum_err[k] / sum_max[k])
        ray_errs = {}
        for what, g_k, w_k in zip(("origin", "dirs", "entry", "exit"), got,
                                  want):
            e, m = float((g_k - w_k).abs().max()), float(w_k.abs().max())
            require(bool(torch.isfinite(g_k).all()) and m > 0
                    and e <= CAMERA_RAY_TOL * m,
                    f"camera {label}: the {what} cotangent, max |diff| {e} > "
                    f"{CAMERA_RAY_TOL} * {m}")
            ray_errs[what] = e / m
        require(o_max > 0 and o_err <= CAMERA_RAY_TOL * o_max,
                f"camera {label}: a tile's origin cotangent, max |diff| "
                f"{o_err} > {CAMERA_RAY_TOL} * {o_max}")
        ray_errs["origin_per_tile"] = o_err / o_max
        lf_k = lf_c.clone().requires_grad_()
        out_k = P.render(vol_i, tf_c, lf_k, cfg_c, sr, u=u_c, ert=ert).image
        torch.sum(out_k * g_m).backward()
        lf_plain = torch.autograd.grad(
            (rays_p.origin, rays_p.dirs, rays_p.entry, rays_p.exit), lf_p,
            want)[0]
        norm = float(lf_plain.norm())
        lf_err = float((lf_k.grad - lf_plain).abs().max()) / norm
        require(bool(torch.isfinite(lf_k.grad).all()) and norm > 0
                and lf_err <= CAMERA_TOL,
                f"camera {label}: d_look_from {lf_k.grad.tolist()} against "
                f"{lf_plain.tolist()}")
        return ({"rel_err_P_S_L_V": errs, "rel_err_ray_tensors": ray_errs,
                 "k2_camera_vs_default_rel": same,
                 "d_look_from": lf_k.grad.tolist(),
                 "d_look_from_plain": lf_plain.tolist(),
                 "d_look_from_rel_err": lf_err, "knife_edge_rays": n_knife,
                 "tiles": len(range(0, H, tile)) * len(range(0, W, tile))},
                lf_plain)

    vol_i = P.volume_to_internal(
        torch.from_numpy(P.noise_volume(res, seed=0)).to(dev)).contiguous()
    u_c = torch.rand((128, 128), generator=gen_a, device=dev)
    g_c = torch.rand((128, 128, 4), generator=gen_a, device=dev) - 0.3
    g_s = torch.rand((16, 16, 4), generator=gen_a, device=dev) - 0.3
    camera = {}
    for analytic in (False, True):
        mode = "analytic" if analytic else "parity"
        cfg_c = cfg.replace(image_shape=(128, 128), analytic_normals=analytic)
        gcfg_c = gcfg.replace(analytic_normals=analytic)
        for ert in (False, True):
            camera[f"noise_128_{mode}_ert_{ert}"] = camera_case(
                vol_i, tf_i, cfg_c, u_c, lf, g_c, 1.0, ert,
                f"noise 128^2 {mode} ert={ert}")[0]
            camera[f"sphere_{mode}_ert_{ert}"] = camera_case(
                sphere, gtf, gcfg_c, None, glf, g_s, 0.8, ert,
                f"sphere {mode} ert={ert}")[0]
    # At the bench: the default gradient step launches no camera
    # instantiation; grad_step_ms with and without the camera gradient.
    rc_cam = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                         jitter=True, max_samples=512, seed=0,
                         camera_grads=True)
    vol_user = P.volume_from_internal(vol_i)[None]
    v_leaf = vol_user.clone().requires_grad_()
    t_leaf = tf_user.clone().requires_grad_()
    lf_leaf = lf.clone().requires_grad_()
    u = torch.rand((img, img), generator=gen_a, device=dev)

    def step_default():
        v_leaf.grad = t_leaf.grad = lf_leaf.grad = None
        rc(v_leaf, t_leaf, lf_leaf, u=u).square().mean().backward()

    def step_camera():
        v_leaf.grad = t_leaf.grad = lf_leaf.grad = None
        rc_cam(v_leaf, t_leaf, lf_leaf, u=u).square().mean().backward()

    P.reset_launch_counts()
    step_default()
    sync()
    default_counts = P.launch_counts()
    require(default_counts["march_diff_bwd"] == 1
            and default_counts["march_diff_bwd.camera"] == 0
            and lf_leaf.grad is None,
            f"the default gradient step launched {default_counts}")
    P.reset_launch_counts()
    step_camera()
    sync()
    camera_counts = P.launch_counts()
    require(camera_counts["march_diff_bwd"] == 1
            and camera_counts["march_diff_bwd.camera"] == 1
            and bool(torch.isfinite(lf_leaf.grad).all()),
            f"the camera gradient step launched {camera_counts}")
    kernels["march_diff_fwd"]["launches"] += 2
    kernels["march_diff_bwd"]["launches"] += 2
    step_ms, step_ms_cam = host_ms_ab(step_default, step_camera, 7)
    rays = P.make_rays(lf, cfg, 1.0, u=u)
    image, _ = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0)
    g_img = 2.0 * image / image.numel()
    # At the step's rays and cotangent: K2's camera instantiation against
    # the plain march over 16 tiles of 128^2, and the step's d_look_from
    # against the plain one (where no ray is on the ERT knife edge, the
    # cotangents are the same).
    sync()
    t_plain = time.perf_counter()
    cam_512, lf_plain = camera_case(vol_i, tf_i, cfg, u, lf, g_img, 1.0,
                                    True, "noise 512^2 step")
    cam_512["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
    step_err = None
    if cam_512["knife_edge_rays"] == 0:
        step_camera()
        step_err = (float((lf_leaf.grad - lf_plain).abs().max())
                    / float(lf_plain.norm()))
        require(step_err <= CAMERA_TOL,
                f"the camera step's d_look_from {lf_leaf.grad.tolist()} "
                f"against {lf_plain.tolist()}")
    cam_512["step_d_look_from_rel_err"] = step_err
    camera["noise_512_step_parity_ert_True"] = cam_512
    sums = torch.empty((img, img, 12), device=dev)
    k2_ms, k2_ms_cam = cuda_ms_ab(
        lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image, g_img),
        lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image, g_img,
                                 sums=sums), 10)
    cc = torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
    _, _, steps_c = P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image,
                                     g_img, counts=cc, sums=sums)
    cam_samples = int((steps_c - 1).sum())
    cam_scattered, cam_quiet_light = (int(cc[..., i].sum()) for i in (0, 1))
    del cc
    b_cam_ms, b_cam_by = bound(
        3 * vol_bytes + R * 32 + ray_bytes + img * img * (36 + 48),
        cam_scattered * (BWD_SAMPLE_OPS + CAMERA_POSITION_OPS)
        + (cam_samples - cam_scattered) * QUIET_SAMPLE_OPS
        + cam_quiet_light * QUIET_LIGHT_OPS
        + cam_samples * CAMERA_SUM_OPS)
    sum_errs = max(max(c["rel_err_P_S_L_V"]) for c in camera.values())
    ray_errs = max(max(c["rel_err_ray_tensors"].values())
                   for c in camera.values())
    lf_errs = max(c["d_look_from_rel_err"] for c in camera.values())
    emit({"phase": "camera", "cases": camera,
          "tolerance_sums": CAMERA_SUM_TOL,
          "tolerance_ray_tensors": CAMERA_RAY_TOL,
          "tolerance_d_look_from": CAMERA_TOL,
          "default_step_launches": default_counts,
          "camera_step_launches": camera_counts,
          "grad_step_ms": step_ms, "grad_step_ms_camera": step_ms_cam,
          "k2_ms": k2_ms, "k2_ms_camera": k2_ms_cam,
          "camera_samples": cam_samples,
          "camera_samples_scattering": cam_scattered,
          "bound_ms_camera": b_cam_ms, "bound_by_camera": b_cam_by,
          "nvidia_smi": smi})
    kernels["march_diff_bwd"].update(
        ms_camera=k2_ms_cam, bound_ms_camera=b_cam_ms,
        grad_step_ms_camera=step_ms_cam,
        camera_max_rel_err_sums=sum_errs,
        camera_max_rel_err_ray_tensors=ray_errs,
        camera_max_rel_err_d_look_from=lf_errs)
    del vol_i, vol_user, v_leaf, t_leaf, image, g_img, sums, lf_plain
    torch.cuda.empty_cache()

    # -- 9d. strips: the row-strip forms against the monolithic ones --------
    from differender_tpu_torch.render import _alive_fraction, _depth_spread

    def user_to_internal(make):
        return P.volume_to_internal(
            torch.from_numpy(make()).to(dev)).contiguous()

    def add_launches(counts, names):
        for name in names:
            kernels[name]["launches"] += counts[name]

    def step_of(fn, vol_i, u, cfg_s=None, lf_s=None):
        """One forward and backward step of ``mean(image^2)`` through
        ``fn`` (``render``'s signature): the output and both gradients."""
        v = vol_i.clone().requires_grad_(True)
        t = tf_i.clone().requires_grad_(True)
        out = fn(v, t, lf if lf_s is None else lf_s,
                 cfg if cfg_s is None else cfg_s, 1.0, u=u)
        torch.mean(out.image ** 2).backward()
        return out, v.grad, t.grad

    def grads_close(got, want, label, whats=("d_volume", "d_tf")):
        """Each gradient within K2_GRAD_TOL * its max of the reference's
        (K2's atomics add in another order); returns the relative errors."""
        errs = []
        for g, w, what in zip(got, want, whats):
            m = float(w.abs().max())
            e = float((g - w).abs().max())
            require(bool(torch.isfinite(g).all()) and m > 0
                    and e <= K2_GRAD_TOL * m,
                    f"{label} {what}: max |diff| {e} > {K2_GRAD_TOL} * {m}")
            errs.append(e / m)
        return errs

    def kernel_ms(fn, names):
        """Device ms per call of ``fn`` of the kernels whose names hold each
        of ``names`` (torch.profiler), or None where none was seen."""
        got = device_kernels(fn, reps=2)
        out = {}
        for n in names:
            hits = [v["ms"] for k, v in got.items() if n in k]
            out[n] = sum(hits) if hits else None
        return out

    t_phase = time.perf_counter()
    u_b = torch.rand((img, img), generator=gen_b, device=dev)
    strips = {}
    for scene, make in (("synthetic", lambda: P.synthetic_volume(res)),
                        ("ct_phantom", lambda: P.ct_phantom(res))):
        vol_i = user_to_internal(make)
        P.reset_launch_counts()
        st = P.render_nondiff_strips(vol_i, tf_i, lf_v, cfg_v, v_sr,
                                     n_strips=4)
        sync()
        counts = P.launch_counts()
        require(counts["march_nondiff"] == 4, f"render_nondiff_strips "
                                              f"launched {counts}")
        count_build(counts, "render_nondiff_strips")
        add_launches(counts, ["march_nondiff"])
        mono = P.render_nondiff(vol_i, tf_i, lf_v, cfg_v, v_sr)
        sync()
        require(torch.equal(st.image, mono.image),
                f"render_nondiff_strips differs from render_nondiff on "
                f"{scene}: {int((st.image != mono.image).any(-1).sum())} px")
        ms_s, ms_m = host_ms_ab(
            lambda: P.render_nondiff_strips(vol_i, tf_i, lf_v, cfg_v, v_sr,
                                            n_strips=4),
            lambda: P.render_nondiff(vol_i, tf_i, lf_v, cfg_v, v_sr), 3)
        strips[f"nondiff_viewer_{scene}"] = {
            "launches": counts, "bitwise_equal": True, "ms": ms_s,
            "ms_monolithic": ms_m}
    vol_i = user_to_internal(scenes["noise"])

    def strips4(*a, **k):
        return P.render_strips(*a, n_strips=4, **k)

    P.reset_launch_counts()
    out_s, dv_s, dt_s = step_of(strips4, vol_i, u_b)
    sync()
    counts = P.launch_counts()
    require(counts["march_diff_fwd"] == 4 and counts["march_diff_bwd"] == 4,
            f"render_strips' step launched {counts}")
    add_launches(counts, ["march_diff_fwd", "march_diff_bwd"])
    out_m, dv_m, dt_m = step_of(P.render, vol_i, u_b)
    sync()
    require(torch.equal(out_s.image, out_m.image)
            and torch.equal(out_s.valid_steps, out_m.valid_steps),
            "render_strips' image or valid_steps differ from render's")
    errs = grads_close((dv_s, dt_s), (dv_m, dt_m), "render_strips")
    ms_s, ms_m = host_ms_ab(lambda: step_of(strips4, vol_i, u_b),
                            lambda: step_of(P.render, vol_i, u_b), 3)
    strips["diff_bench_noise"] = {
        "launches": counts, "bitwise_equal": True,
        "grad_rel_err_d_volume_d_tf": errs, "grad_step_ms": ms_s,
        "grad_step_ms_monolithic": ms_m}
    del out_s, dv_s, dt_s, out_m, dv_m, dt_m
    emit({"phase": "strips", "cases": strips, "n_strips": 4,
          "viewer": [v_img, v_sr], "bench": [res, img],
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 9e. depth_sorted: rays sorted by predicted depth --------------------
    t_phase = time.perf_counter()
    sorted_cases = {}

    def sorted4(*a, **k):
        return P.render_depth_sorted(*a, chunks=4, **k)

    for scene in ("noise", "ct_phantom"):
        vol_i = user_to_internal(scenes[scene])
        P.reset_launch_counts()
        out_s, dv_s, dt_s = step_of(sorted4, vol_i, u_b)
        sync()
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 4
                and counts["march_diff_bwd"] == 4,
                f"render_depth_sorted's step launched {counts}")
        count_build(counts, "render_depth_sorted's sort key")
        add_launches(counts, ["march_diff_fwd", "march_diff_bwd"])
        out_m, dv_m, dt_m = step_of(P.render, vol_i, u_b)
        sync()
        require(torch.equal(out_s.image, out_m.image)
                and torch.equal(out_s.valid_steps, out_m.valid_steps),
                f"render_depth_sorted's image or valid_steps differ from "
                f"render's on {scene}")
        errs = grads_close((dv_s, dt_s), (dv_m, dt_m),
                           f"render_depth_sorted on {scene}")
        del out_s, dv_s, dt_s, out_m, dv_m, dt_m
        ms_s, ms_m = host_ms_ab(lambda: step_of(sorted4, vol_i, u_b),
                                lambda: step_of(P.render, vol_i, u_b), 3)
        names = ["march_diff_fwd_kernel", "march_diff_bwd_kernel"]
        k_s = kernel_ms(lambda: step_of(sorted4, vol_i, u_b), names)
        k_m = kernel_ms(lambda: step_of(P.render, vol_i, u_b), names)
        sorted_cases[scene] = {
            "launches": counts, "bitwise_equal": True,
            "grad_rel_err_d_volume_d_tf": errs,
            "grad_step_ms_sorted": ms_s, "grad_step_ms_unsorted": ms_m,
            "k1_ms_sorted": k_s[names[0]], "k1_ms_unsorted": k_m[names[0]],
            "k2_ms_sorted": k_s[names[1]], "k2_ms_unsorted": k_m[names[1]]}
    emit({"phase": "depth_sorted", "cases": sorted_cases, "chunks": 4,
          "chunk_image": [img // 4, img], "bench": [res, img],
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 9f. policy: the scene-adaptive choice of the renderer ---------------
    t_phase = time.perf_counter()
    policy = {}
    probe_cfg = cfg.replace(image_shape=(128, 128), compact_after=0)
    for scene in ("noise", "ct_phantom"):
        vol_i = user_to_internal(scenes[scene])
        fn, name = P.choose_diff_renderer(vol_i, tf_i, lf, cfg)
        policy[scene] = {
            "name": name,
            "alive_fraction_after_2_blocks": _alive_fraction(
                vol_i, tf_i, lf, probe_cfg, 1.0, 2 * cfg.block_size),
            "depth_spread": _depth_spread(vol_i, tf_i, lf, cfg, 1.0)}
    fn, name = P.choose_diff_renderer(vol_i, tf_i, lf, cfg, probe="timed")
    with torch.no_grad():
        got = fn(vol_i, tf_i, lf, cfg, 1.0, u=u_b).image
        want = P.render(vol_i, tf_i, lf, cfg, 1.0, u=u_b).image
    err = float((got - want).abs().max())
    require(err <= 1e-5 * float(want.abs().max()),
            f"the timed probe's {name} renders {err} from render")
    policy["ct_phantom_timed"] = {"name": name, "max_abs_err_vs_render": err}
    emit({"phase": "policy", "cases": policy,
          "thresholds": {"alive": 0.125, "depth_spread": 0.25},
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 9g. blockwise512: the 512^3 gradient step ----------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg512 = P.RenderConfig(volume_shape=(512,) * 3, image_shape=(img, img),
                            max_samples=512, block_size=32,
                            march_vjp="sorted", march_table="super64s2")
    g512 = torch.Generator(device=dev)
    g512.manual_seed(1)
    vol512 = torch.rand((512,) * 3, generator=g512, device=dev) * 0.5

    def loss512(out):
        return torch.mean(out.image ** 2)

    torch.cuda.reset_peak_memory_stats(dev)
    P.reset_launch_counts()
    (loss_b, (dv_b, dt_b)), ms_once = timed_once(
        lambda: P.value_and_grad_blockwise(vol512, tf_i, lf, cfg512,
                                           loss512))
    counts = P.launch_counts()
    peak_b = torch.cuda.max_memory_allocated(dev)
    require(counts["march_diff_fwd"] == 1 and counts["march_diff_bwd"] == 1,
            f"value_and_grad_blockwise launched {counts}")
    add_launches(counts, ["march_diff_fwd", "march_diff_bwd"])
    loss_r, (dv_r, dt_r) = P.value_and_grad_render(vol512, tf_i, lf, cfg512,
                                                   loss512)
    sync()
    require(float(loss_b) == float(loss_r),
            f"blockwise loss {float(loss_b)} != value_and_grad_render's "
            f"{float(loss_r)}")
    errs = grads_close((dv_b, dt_b), (dv_r, dt_r), "blockwise 512^3")
    del dv_b, dt_b, dv_r, dt_r
    # The step's kernels on the 512^3 volume against the plain march, on a
    # corner tile of 128^2 on the box's silhouette and a central one: K1's
    # image and counts, and K2 for a cotangent that is 0 off those tiles.
    t_plain = time.perf_counter()
    rays512 = P.make_rays(lf, cfg512, 1.0)
    image512, steps512 = P.march_diff_fwd(vol512, tf_i, rays512, cfg512,
                                          1.0)
    b_tiles, b_blocks, b_mask = spread_tiles(rays512.n_samples, 128,
                                             ("corner", "centre"))
    agree512 = torch.ones((img, img), dtype=torch.bool, device=dev)
    k1_512_err = 0.0
    for blk in b_blocks:
        rays_t, cfg_t = tile_of(rays512, cfg512, blk)
        with torch.no_grad():
            want_t, wsteps_t = P.march_diff_plain(vol512, tf_i, rays_t,
                                                  cfg_t, 1.0)
        k1_512_err = max(k1_512_err, image_check(
            "K1 at 512^3", image512[blk], want_t)[0])
        count_check("K1 at 512^3 valid_steps", steps512[blk], wsteps_t)
        agree512[blk] = steps512[blk] == wsteps_t
    knife512 = int((~agree512).sum())
    require(knife512 <= 1e-3 * len(b_blocks) * 128 * 128,
            f"{knife512} knife-edge rays on the 512^3 tiles")
    cot512 = (torch.rand((img, img, 4), generator=g512, device=dev)
              - 0.3) * agree512[..., None] * b_mask
    got512 = P.march_diff_bwd(vol512, tf_i, rays512, cfg512, 1.0, image512,
                              cot512)[:2]
    want512 = plain_bwd_tiled(vol512, tf_i, rays512, cfg512, cot512, 128)
    plain512_errs = k2_grad_errs(got512, want512,
                                 "512^3 (512, 512), ert=True")
    sync()
    plain512_s = time.perf_counter() - t_plain
    del got512, want512, cot512, image512, steps512, rays512
    ms_b, ms_r = host_ms_ab(
        lambda: P.value_and_grad_blockwise(vol512, tf_i, lf, cfg512,
                                           loss512),
        lambda: P.value_and_grad_render(vol512, tf_i, lf, cfg512, loss512),
        2)
    del vol512
    torch.cuda.empty_cache()
    # A batched gradient step of the Raycaster at the bench: two views.
    vols2 = torch.stack([torch.from_numpy(scenes[s]()).to(dev)[None]
                         for s in ("noise", "ct_phantom")])
    lf2 = torch.tensor([[1.2, 0.8, 2.0], [-1.0, 0.4, 2.1]], device=dev)
    u2 = torch.rand((2, img, img), generator=g512, device=dev)

    def batch_step():
        v = vols2.clone().requires_grad_(True)
        t = tf_user.clone().requires_grad_(True)
        out = rc(v, t, lf2, u=u2)
        torch.mean(out ** 2).backward()
        return out, v.grad, t.grad

    torch.cuda.reset_peak_memory_stats(dev)
    P.reset_launch_counts()
    out2, dv2, dt2 = batch_step()
    sync()
    counts2 = P.launch_counts()
    peak_2 = torch.cuda.max_memory_allocated(dev)
    require(counts2["march_diff_fwd"] == 2 and counts2["march_diff_bwd"] == 2
            and out2.shape == (2, 4, img, img)
            and bool(torch.isfinite(dv2).all() & torch.isfinite(dt2).all()),
            f"the batched Raycaster step launched {counts2}")
    add_launches(counts2, ["march_diff_fwd", "march_diff_bwd"])
    # Each view against render on that view alone (the same loss term):
    # the image bitwise, its d_volume, and d_tf summed over the views.
    dt_views = torch.zeros_like(tf_i)
    batch_errs = []
    for i in range(2):
        v_one = P.volume_to_internal(vols2[i, 0]).contiguous() \
            .requires_grad_(True)
        t_one = tf_i.clone().requires_grad_(True)
        one = P.render(v_one, t_one, lf2[i], cfg, 1.0, u=u2[i]).image
        (torch.sum(one ** 2) / out2.numel()).backward()
        require(torch.equal(out2[i].detach(), one.detach().permute(2, 0, 1)),
                f"the batched Raycaster's view {i} differs from render's")
        batch_errs += grads_close((P.volume_to_internal(dv2[i, 0]),),
                                  (v_one.grad,),
                                  f"the batched Raycaster's view {i}")
        dt_views += t_one.grad
    batch_errs += grads_close((P.tf_to_internal(dt2),), (dt_views,),
                              "the batched Raycaster's", ("d_tf",))
    del out2, dv2, dt2, v_one, t_one, one, dt_views
    ms_2 = host_ms(batch_step, 2)
    del vols2
    emit({"phase": "blockwise512", "volume": 512, "image": img,
          "config": {"march_vjp": "sorted", "march_table": "super64s2",
                     "block_size": 32, "max_samples": 512},
          "launches": counts, "loss": float(loss_b),
          "loss_equal_value_and_grad_render": True,
          "grad_rel_err_d_volume_d_tf": errs,
          "vs_plain": {"tiles_128": b_tiles,
                       "k1_max_abs_err": k1_512_err,
                       "k2_rel_err_d_volume_d_tf": plain512_errs,
                       "knife_edge_rays": knife512,
                       "seconds": plain512_s},
          "first_step_ms": ms_once,
          "grad_step_ms": ms_b, "grad_step_ms_value_and_grad_render": ms_r,
          "peak_bytes": peak_b,
          "batched_raycaster": {"views": 2, "launches": counts2,
                                "images_equal_render": True,
                                "grad_rel_err_view0_view1_d_tf": batch_errs,
                                "grad_step_ms": ms_2, "peak_bytes": peak_2},
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 9h. fastpath: the shear-warp renderer --------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    from differender_tpu_torch import fastpath as PF
    from differender_tpu_torch.ops import shear_warp as SW
    O_fast, ppv = 576, 2.0
    fast = {}
    for name in ("shear_warp_fwd", "shear_warp_bwd"):
        kernels[name] = dict(
            route="cuda", source="differender_tpu_torch/csrc/shear_warp.cu",
            replaces="differender_tpu/fastpath.py:255",
            replaces_note="the z-lerp (:216-229) and the slab scan's step "
                          "slab_fn (:255) with shade_slab (:171) under "
                          "slab_step (:291)"
                          + (", and JAX's AD of it" if name.endswith("bwd")
                             else "") + ": XLA, no Pallas kernel",
            launches=0, max_abs_err=0.0, library_ms=None,
            resources=ptxas_of("shear_warp.cu", [name + "_kernel"]))

    def fast_step(fn, vol_i, slab_batch=32, tf_s=None, cfg_s=None, O_s=None,
                  ppv_s=None):
        v = vol_i.clone().requires_grad_(True)
        t = (tf_i if tf_s is None else tf_s).clone().requires_grad_(True)
        out = fn(v, t, lf, cfg if cfg_s is None else cfg_s,
                 intermediate=O_fast if O_s is None else O_s,
                 planes_per_voxel=ppv if ppv_s is None else ppv_s,
                 slab_batch=slab_batch)
        torch.mean(out.image ** 2).backward()
        return out, v.grad, t.grad

    def fast_fwd(fn, vol_i, slab_batch=32):
        with torch.no_grad():
            return fn(vol_i, tf_i, lf, cfg, intermediate=O_fast,
                      planes_per_voxel=ppv, slab_batch=slab_batch)

    held = []

    def march_args(vol_i, O_s=O_fast, lf_s=None, cfg_s=None, tf_s=None):
        """render_fast's voxel layers, geometry and K8's argument struct
        at a view (by default the bench's), with K8's output, its per-pixel
        stop planes and samples taken, and the cotangent of the
        intermediate image in mean(image^2)'s step."""
        lf_s = lf if lf_s is None else lf_s
        cfg_s = cfg if cfg_s is None else cfg_s
        tf_s = tf_i if tf_s is None else tf_s
        ch, lf_f, light_f, perm, sign = PF._frame(vol_i, lf_s)
        layers, geom, ext = PF._slab_inputs(ch, lf_f, light_f, cfg_s, O_s,
                                            ppv)
        del ch
        a, keep = SW._args(layers, tf_s, geom)
        held.append(keep)       # the operands ``a`` points into
        inter = torch.empty((O_s, O_s, 4), device=dev)
        steps = torch.zeros((O_s, O_s), dtype=torch.int32, device=dev)
        taken = torch.zeros_like(steps)
        a.inter, a.steps, a.taken = (inter.data_ptr(), steps.data_ptr(),
                                     taken.data_ptr())
        _build.check(_build.library().dr_shear_warp_fwd(
            ctypes.byref(a), dev.index or 0, _build.stream_of(layers)), "K8")
        leaf = inter.clone().requires_grad_(True)
        img_w, _ = PF._warp_to_image(leaf, ext, lf_s, cfg_s, perm, sign)
        g_inter, = torch.autograd.grad(torch.mean(img_w ** 2), leaf)
        a.steps = a.taken = None
        return layers, geom, a, inter, steps, taken, g_inter.contiguous()

    def march_work(geom, stop, X, Y, Z):
        """What a march that stops at the planes ``stop`` needs, from the
        geometry alone (never from a kernel's counter): per pixel, its
        in-footprint samples (plane s where both crossings lie inside and
        s < stop); the slab texels their taps of non-zero weight read and
        the voxel-layer texels those are z-lerped from (weight not 0), each
        counted once.  Returns (samples per pixel, slab texels, layer
        texels)."""
        x_in, y_in = SW.footprint(geom, X, Y)
        _, src_x, src_y = SW._sources(geom, geom.zws)
        tx, ty = SW._lerp_taps(src_x, X), SW._lerp_taps(src_y, Y)
        zlo, zhi = geom.zlo.tolist(), geom.zhi.tolist()
        fz = geom.fz.tolist()
        per_pixel = torch.zeros(stop.shape, dtype=torch.int64, device=dev)
        layer = torch.zeros((Z, X * Y), dtype=torch.bool, device=dev)
        slab_texels = 0

        def taps_matrix(t, n, size):
            """(B, n, size): 1 where a row (column) reads a texel with a
            weight that is not 0."""
            m = torch.zeros((t[0].shape[0], n, size), device=dev)
            m.scatter_add_(2, t[0][..., None], (t[2] != 0).float()[..., None])
            m.scatter_add_(2, t[1][..., None], (t[3] != 0).float()[..., None])
            return (m > 0).float()

        for s0 in range(0, int(stop.max()), 16):
            sl = slice(s0, min(s0 + 16, geom.zws.numel()))
            B = sl.stop - s0
            live = ((stop[None] > torch.arange(s0, sl.stop, device=dev)[
                :, None, None]) & x_in[sl][:, :, None] & y_in[sl][:, None, :])
            per_pixel += live.sum(0)
            ax = taps_matrix([t[sl] for t in tx], stop.shape[0], X)
            ay = taps_matrix([t[sl] for t in ty], stop.shape[1], Y)
            need = torch.bmm(torch.bmm(ax.transpose(1, 2), live.float()),
                             ay).reshape(B, X * Y) > 0
            slab_texels += int(need.sum())
            for j in range(B):
                layer[zlo[s0 + j]] |= need[j]
                if fz[s0 + j] != 0.0:
                    layer[zhi[s0 + j]] |= need[j]
        return per_pixel, slab_texels, int(layer.sum())

    def k8_k9_bounds(geom, steps, g_inter, X, Y, Z, O_s):
        """K8's and K9's bounds at a view: operations over the in-footprint
        samples before each pixel's stop plane (K9: of the pixels whose
        cotangent is not 0) and the z-lerp of each needed slab texel; bytes
        of the layer texels those need, each read once (K9 also writes
        d_layers once on them), the exponent, the TF and the image (K9 also
        its cotangent)."""
        per_px, slab_tx, layer_tx = march_work(geom, steps, X, Y, Z)
        live_g = (g_inter != 0).any(-1)
        per_px_b, slab_tx_b, layer_tx_b = march_work(
            geom, torch.where(live_g, steps, 0), X, Y, Z)
        samples, samples_b = int(per_px.sum()), int(per_px_b.sum())
        b8 = bound(layer_tx * 16 + O_s * O_s * (4 + 16) + R * 16,
                   samples * SW_SAMPLE_OPS + slab_tx * SW_ZLERP_OPS)
        b9 = bound(layer_tx_b * 2 * 16 + O_s * O_s * (4 + 2 * 16) + R * 32,
                   samples_b * SW_BWD_SAMPLE_OPS + slab_tx_b * SW_ZLERP_OPS)
        work = {"samples_in_footprint": samples,
                "samples_in_footprint_bwd": samples_b,
                "slab_texels_needed": slab_tx,
                "slab_texels_needed_bwd": slab_tx_b,
                "layer_texels_needed": layer_tx,
                "layer_texels_needed_bwd": layer_tx_b,
                # Every plane before the stop plane, in the footprint
                # or not.
                "samples_before_stop": int(steps.sum()),
                "samples_before_stop_bwd": int(
                    torch.where(live_g, steps, 0).sum())}
        return b8, b9, per_px, work

    for scene in ("noise", "ct_phantom"):
        vol_i = user_to_internal(scenes[scene])
        P.reset_launch_counts()
        out = fast_fwd(P.render_fast, vol_i)
        sync()
        c_fwd = P.launch_counts()
        require(c_fwd["shear_warp_fwd"] == 1 and sum(c_fwd.values()) == 1,
                f"render_fast's forward launched {c_fwd}")
        kernels["shear_warp_fwd"]["launches"] += 1
        plain = fast_fwd(P.render_fast_plain, vol_i)
        sync()
        err = float((out.image - plain.image).abs().max())
        require(err <= 1e-5 and torch.equal(out.hit, plain.hit)
                and bool(torch.isfinite(out.image).all()),
                f"render_fast on {scene}: {err} from render_fast_plain")
        kernels["shear_warp_fwd"]["max_abs_err"] = max(
            kernels["shear_warp_fwd"]["max_abs_err"], err)
        # K8 runs no atomics: bitwise across calls, and slab_batch (the
        # plain march's chunk) is ignored on the card.
        require(torch.equal(fast_fwd(P.render_fast, vol_i).image, out.image)
                and torch.equal(fast_fwd(P.render_fast, vol_i, 2).image,
                                out.image),
                "render_fast's image differs across calls or slab batches")
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        tf32_img = fast_fwd(P.render_fast, vol_i).image
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])
        require(torch.equal(tf32_img, out.image),
                "render_fast's image changes with TF32 allowed")
        # The step's own peak: what it allocates above what lies allocated
        # before it (the scenes, earlier phases' caches).
        base_f = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        P.reset_launch_counts()
        _, dv_k, dt_k = fast_step(P.render_fast, vol_i)
        sync()
        c_step = P.launch_counts()
        peak_f = torch.cuda.max_memory_allocated(dev)
        require(c_step["shear_warp_fwd"] == 1
                and c_step["shear_warp_bwd"] == 1
                and sum(c_step.values()) == 2,
                f"render_fast's step launched {c_step}")
        kernels["shear_warp_fwd"]["launches"] += 1
        kernels["shear_warp_bwd"]["launches"] += 1
        # The plain gradient at chunks of 2 slabs (the gradient does not
        # depend on the batch): its d_tf is index_add_'s f32 sum, whose
        # rounding grows with the lookups a chunk adds onto each texel.
        _, dv_p, dt_p = fast_step(P.render_fast_plain, vol_i, slab_batch=2)
        sync()
        errs = grads_close((dv_k, dt_k), (dv_p, dt_p),
                           f"render_fast on {scene}")
        kernels["shear_warp_bwd"]["max_abs_err"] = max(
            kernels["shear_warp_bwd"]["max_abs_err"],
            float((dv_k - dv_p).abs().max()),
            float((dt_k - dt_p).abs().max()))
        del dv_k, dt_k, dv_p, dt_p, tf32_img
        fwd_ms, plain_fwd_ms = host_ms_ab(
            lambda: fast_fwd(P.render_fast, vol_i),
            lambda: fast_fwd(P.render_fast_plain, vol_i), 3)
        step_ms = host_ms(lambda: fast_step(P.render_fast, vol_i), 3)
        plain_step_ms = host_ms(
            lambda: fast_step(P.render_fast_plain, vol_i), 1)
        fast_ms, k3_ms = host_ms_ab(
            lambda: fast_fwd(P.render_fast, vol_i),
            lambda: P.render_nondiff(vol_i, tf_i, lf, cfg), 3)
        # K8 and K9 by CUDA events around their C entries at the bench
        # view's inputs (without the counters, as the wrappers call them),
        # K9 with the step's own cotangent; K8's samples taken equal the
        # in-footprint samples before each pixel's stop plane, counted from
        # the geometry; K9's restarts.
        layers, geom, a, inter, steps, taken, g_inter = march_args(vol_i)
        Z, X, Y = layers.shape[:3]
        S = geom.zws.numel()
        stream = _build.stream_of(layers)
        k8_ms = launch_ms(lambda: _build.library().dr_shear_warp_fwd(
            ctypes.byref(a), dev.index or 0, stream), reps=10, per_pair=10)
        d_L = torch.zeros_like(layers)
        d_tf = torch.zeros_like(tf_i)
        restarts = torch.zeros((O_fast, O_fast), dtype=torch.int32,
                               device=dev)
        a.grad, a.d_layers, a.d_tf, a.restarts = (
            g_inter.data_ptr(), d_L.data_ptr(), d_tf.data_ptr(),
            restarts.data_ptr())
        _build.check(_build.library().dr_shear_warp_bwd(
            ctypes.byref(a), dev.index or 0, stream), "K9")
        sync()
        n_restarts = int(restarts.sum())
        a.restarts = None
        k9_ms = launch_ms(lambda: _build.library().dr_shear_warp_bwd(
            ctypes.byref(a), dev.index or 0, stream), reps=5, per_pair=4)
        b8, b9, per_px, work = k8_k9_bounds(geom, steps, g_inter, X, Y, Z,
                                            O_fast)
        require(torch.equal(taken.long(), per_px),
                f"K8's samples taken on {scene}: {int(taken.sum())}, the "
                f"in-footprint samples before the stop planes "
                f"{int(per_px.sum())}")
        with torch.no_grad():
            k8_plain_ms = host_ms(
                lambda: SW.shear_warp_march_plain(layers, tf_i, geom), 1)
        k9_plain_ms = host_ms(
            lambda: SW.shear_warp_bwd_plain(layers, tf_i, geom, g_inter), 1)
        del layers, geom, a, inter, g_inter, d_L, d_tf, restarts, per_px
        # A strip of K8 (rows [O/4, O/2)) is the whole image's rows.
        with torch.no_grad():
            args = (vol_i, tf_i, lf, cfg, O_fast, ppv, 32,
                    SW.shear_warp_march)
            whole = PF._intermediate(*args)[0]
            strip = PF._intermediate(*args, O_fast // 4, O_fast // 4)[0]
            require(torch.equal(strip, whole[O_fast // 4:O_fast // 2]),
                    "a strip of K8 differs from the whole image's rows")
            exact = P.render(vol_i, tf_i, lf, cfg, 1.0).image
        del whole, strip
        if scene == "noise":    # the bench scene is the one reported
            kernels["shear_warp_fwd"].update(
                ms=k8_ms, plain_ms=k8_plain_ms, bound_ms=b8[0],
                bound_by=b8[1])
            kernels["shear_warp_bwd"].update(
                ms=k9_ms, plain_ms=k9_plain_ms, bound_ms=b9[0],
                bound_by=b9[1])
        fast[scene] = {
            "launches_forward": c_fwd, "launches_step": c_step,
            "max_abs_err_vs_plain": err,
            "grad_rel_err_d_volume_d_tf": errs, "fwd_ms": fwd_ms,
            "plain_fwd_ms": plain_fwd_ms, "grad_step_ms": step_ms,
            "plain_grad_step_ms": plain_step_ms, "grad_peak_bytes": peak_f,
            "grad_step_own_peak_bytes": peak_f - base_f,
            "k8_ms": k8_ms, "k8_plain_ms": k8_plain_ms,
            "k8_bound_ms": b8[0], "k8_bound_by": b8[1],
            "k9_ms": k9_ms, "k9_plain_ms": k9_plain_ms,
            "k9_bound_ms": b9[0], "k9_bound_by": b9[1],
            "planes": S, "k8_taken": int(taken.sum()),
            "k8_taken_equals_footprint": True, "k9_restarts": n_restarts,
            "samples_all_planes": S * O_fast * O_fast, **work,
            "layer_texels": Z * X * Y,
            "vs_k3": {"render_fast_ms": fast_ms,
                      "render_nondiff_ms": k3_ms, "sampling_rate": 4.0},
            "ssim_vs_render": float(P.ssim(out.image.permute(2, 0, 1),
                                           exact.permute(2, 0, 1))),
            "choose_fast_params": P.choose_fast_params(vol_i, tf_i, lf,
                                                       cfg)}
        del out, plain, exact, steps, taken
    # Few pixels per texel (O = 128 against X = 256: a warp's taps spread
    # over 4 texels a pixel): the forward and the step against the plain
    # version.
    vol_i = user_to_internal(scenes["noise"])
    out_k, dv_k, dt_k = fast_step(P.render_fast, vol_i, O_s=128)
    out_p, dv_p, dt_p = fast_step(P.render_fast_plain, vol_i, slab_batch=2,
                                  O_s=128)
    e_small_o = float((out_k.image - out_p.image).detach().abs().max())
    require(e_small_o <= 1e-5 and torch.equal(out_k.hit, out_p.hit),
            f"render_fast at O = 128: {e_small_o} from the plain")
    fast["intermediate_128"] = {
        "max_abs_err_vs_plain": e_small_o,
        "grad_rel_err_d_volume_d_tf": grads_close(
            (dv_k, dt_k), (dv_p, dt_p), "render_fast at O = 128")}
    kernels["shear_warp_fwd"]["max_abs_err"] = max(
        kernels["shear_warp_fwd"]["max_abs_err"], e_small_o)
    del vol_i, out_k, dv_k, dt_k, out_p, dv_p, dt_p
    # Small cases at 64^3, O = 96, each against the plain version: a TF
    # whose alpha reaches exactly 1 (f = 0 at the last sample of a pixel)
    # and 4 planes per voxel (the opacity correction's exponent below 1).
    vol64 = user_to_internal(lambda: P.noise_volume(64, seed=1))
    cfg64 = cfg.replace(volume_shape=(64,) * 3, image_shape=(64, 64),
                        tf_resolution=16)
    tf_op = torch.zeros((16, 4), device=dev)
    tf_op[:, :3] = torch.linspace(0.2, 0.9, 48, device=dev).reshape(16, 3)
    tf_op[:, 3] = torch.clamp(torch.linspace(-0.5, 1.5, 16, device=dev),
                              0.0, 1.0)
    tf16 = P.tf_to_internal(P.get_tf_torch_layout("tf1", 16, device=dev))
    for name, tf_s, ppv_s in (("opaque_tf", tf_op, 2.0),
                              ("planes_per_voxel_4", tf16, 4.0)):
        kw = dict(tf_s=tf_s, cfg_s=cfg64, O_s=96, ppv_s=ppv_s)
        out_k, dv_k, dt_k = fast_step(P.render_fast, vol64, **kw)
        out_p, dv_p, dt_p = fast_step(P.render_fast_plain, vol64,
                                      slab_batch=2, **kw)
        e_small = float((out_k.image - out_p.image).detach().abs().max())
        require(e_small <= 1e-5 and torch.equal(out_k.hit, out_p.hit)
                and not any(bool(torch.isnan(t).any())
                            for t in (dv_k, dt_k, dv_p, dt_p)),
                f"render_fast's {name} case: {e_small} from the plain")
        fast[name] = {"max_abs_err_vs_plain": e_small,
                      "grad_rel_err_d_volume_d_tf": grads_close(
                          (dv_k, dt_k), (dv_p, dt_p), name),
                      "tf_alpha_max": float(tf_s[:, 3].max())}
    del vol64
    # K0b's dot mask (still exported; the fast path no longer launches K0
    # or K0b): quantised intensities on integer t keep no slope, the
    # Pallas mask keeps it.
    x_q = (torch.randint(0, R, (1 << 20,), generator=gen_b, device=dev)
           .float() / (R - 1))
    g_q = torch.rand((1 << 20, 4), generator=gen_b, device=dev) - 0.5
    d_tf_q, d_x_q = P.tf_lookup_bwd(tf_i, x_q, g_q, mask="dot")
    ref_tf_q, ref_x_q = P.tf_lookup_bwd_reference(tf_i, x_q, g_q, mask="dot")
    _, d_x_pallas = P.tf_lookup_bwd(tf_i, x_q, g_q)
    t_q = x_q * (R - 1)
    on_grid = (t_q == torch.floor(t_q)) & (t_q > 0) & (t_q < R - 1)
    mask_err = float((d_x_q - ref_x_q).abs().max())
    require(mask_err <= 1e-5 and bool(on_grid.any())
            and not bool(d_x_q[on_grid].any())
            and bool((d_x_pallas[on_grid] != 0).any())
            and float((d_tf_q - ref_tf_q).abs().max())
            <= 1e-4 * float(ref_tf_q.abs().max()),
            f"K0b's dot mask: d_intensity {mask_err} from its plain version")
    kernels["tf_lookup_bwd"]["mask_dot_max_abs_err"] = mask_err
    # The viewer through Raycaster.raycast_fast (O = 1024 by default).
    for scene, make in (("synthetic", lambda: P.synthetic_volume(res)),
                        ("ct_phantom", lambda: P.ct_phantom(res))):
        vol_user = torch.from_numpy(make()).to(dev)[None]
        P.reset_launch_counts()
        sw = rc_v.raycast_fast(vol_user, tf_user, lf_v)
        sync()
        c_v = P.launch_counts()
        require(c_v["shear_warp_fwd"] == 1 and sum(c_v.values()) == 1
                and sw.shape == (4, v_img, v_img)
                and bool(torch.isfinite(sw).all()),
                f"raycast_fast at the viewer launched {c_v}")
        kernels["shear_warp_fwd"]["launches"] += 1
        exact = rc_v.raycast_nondiff(vol_user, tf_user, lf_v,
                                     sampling_rate=v_sr)
        sw_ms, nd_ms = host_ms_ab(
            lambda: rc_v.raycast_fast(vol_user, tf_user, lf_v),
            lambda: rc_v.raycast_nondiff(vol_user, tf_user, lf_v,
                                         sampling_rate=v_sr), 3)
        # K8 alone at the viewer's intermediate image: its samples taken
        # against the footprint, its bound and the plain march's time.
        vol_v = P.volume_to_internal(vol_user[0]).contiguous()
        layers, geom, a, inter, steps, taken, g_v = march_args(
            vol_v, 1024, lf_v, rc_v.config, tf_i)
        Z, X, Y = layers.shape[:3]
        k8_v_ms = launch_ms(lambda: _build.library().dr_shear_warp_fwd(
            ctypes.byref(a), dev.index or 0, _build.stream_of(layers)),
            reps=10, per_pair=10)
        b8_v, _, per_px, work_v = k8_k9_bounds(geom, steps, g_v, X, Y, Z,
                                               1024)
        require(torch.equal(taken.long(), per_px),
                f"K8's samples taken at the viewer on {scene}: "
                f"{int(taken.sum())}, the in-footprint samples before the "
                f"stop planes {int(per_px.sum())}")
        with torch.no_grad():
            k8_v_plain_ms = host_ms(
                lambda: SW.shear_warp_march_plain(layers, tf_i, geom), 1)
        fast[f"viewer_{scene}"] = {
            "launches": c_v, "intermediate": 1024, "planes_per_voxel": 2.0,
            "ssim_vs_raycast_nondiff": float(P.ssim(sw, exact)),
            "raycast_fast_ms": sw_ms, "raycast_nondiff_ms": nd_ms,
            "k8_ms": k8_v_ms, "k8_plain_ms": k8_v_plain_ms,
            "k8_bound_ms": b8_v[0], "k8_bound_by": b8_v[1],
            "k8_taken": int(taken.sum()), "k8_taken_equals_footprint": True,
            "samples_all_planes": geom.zws.numel() * 1024 * 1024,
            **{k: v for k, v in work_v.items() if not k.endswith("_bwd")}}
        del sw, exact, layers, geom, a, inter, steps, taken, g_v, per_px
    emit({"phase": "fastpath", "cases": fast, "volume": res, "image": img,
          "intermediate": O_fast, "planes_per_voxel": ppv,
          "k0b_dot_mask_max_abs_err": mask_err,
          "resources": {n: kernels[n]["resources"]
                        for n in ("shear_warp_fwd", "shear_warp_bwd")},
          "device_ms_is": "CUDA events around back-to-back calls of the C "
                          "entry, median",
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    del x_q, g_q
    torch.cuda.empty_cache()

    # -- 9i. parallel: the parallel layer on one card -------------------------
    t_phase = time.perf_counter()
    import shutil
    import tempfile

    import torch.distributed as dist
    from differender_tpu_torch import parallel as PP
    from differender_tpu_torch.parallel import volume_sharding as PV
    from differender_tpu_torch.render import (_launch_k2, _launch_march,
                                              _ray_soa)

    def k1_segment(pad, tf, soa, seg, cfg, sr, counts=None):
        """One launch of K1's segment instantiation, counted."""
        with _build.launch("march_segment_fwd"):
            return _launch_march(pad, tf, soa, cfg, sr, False, counts,
                                 segment=seg)

    def k2_segment(pad, tf, soa, seg, cfg, sr, acc, grad, counts=None,
                   sums=None):
        """One launch of K2's segment instantiation, counted; its camera
        instantiation where ``sums`` is given."""
        with _build.launch("march_segment_bwd", camera=sums is not None):
            return _launch_k2(pad, tf, soa, cfg, sr, acc, grad, False,
                              counts, sums, segment=seg)

    # One NCCL rank: the card's machine has one card, and NCCL takes one
    # rank per card.  The K shards' segments run one after another here.
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method="file://" + os.path.join(store, "s"))
    try:
        backend = str(dist.get_backend())
        nccl = ".".join(str(x) for x in torch.cuda.nccl.version())
        print(f"parallel: backend {backend}, NCCL {nccl}", flush=True)
        require(backend == "nccl", f"the process group's backend is "
                                   f"{backend}")
        par = {"backend": backend, "nccl": nccl, "world_size": 1}
        length, _ = PV.segment_length(cfg, 1.0)
        u_p = torch.rand((img, img), generator=gen_b, device=dev)
        rays_p = P.make_rays(lf, cfg, 1.0, u=u_p)
        dir_x = rays_p.dirs[..., 0]
        seg_fwd_err, seg_bwd_err = 0.0, 0.0

        def composed(vol_i, n, rays_c, cfg_c, length_c, t=None):
            """The n shards' segments (K1 segment through segment_march)
            composed, and their counts."""
            t = tf_i if t is None else t
            outs = [PP.segment_march(PV.pad_halos(vol_i, k, n), t, rays_c,
                                     cfg_c, 1.0, k, n, length_c)
                    for k in range(n)]
            image, valid = PV.compose_segments(
                torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]), rays_c.dirs[..., 0])
            return image, valid, outs

        # 1./2. K shards on one card against render(ert=False), and the
        # gradient through K = 4 segments against K2's render(ert=False).
        for scene in ("noise", "ct_phantom"):
            vol_i = user_to_internal(scenes[scene])
            want, want_steps = P.march_diff_fwd(vol_i, tf_i, rays_p, cfg,
                                                1.0, ert=False)
            for n in ((4, 8) if scene == "noise" else (4,)):
                image, valid, _ = composed(vol_i, n, rays_p, cfg, length)
                err = float((image - want).abs().max())
                require(err <= 2e-4 and torch.equal(valid, want_steps),
                        f"{n} segments on {scene}: max |diff| {err} from "
                        f"render(ert=False), valid_steps equal "
                        f"{torch.equal(valid, want_steps)}")
                par[f"{scene}_K{n}"] = {"max_abs_err": err,
                                        "valid_steps_equal": True}
            # The gradient of mean(image^2) through the 4 segments, against
            # render_volume_sharded's at world size 1 (one segment over the
            # whole volume: JAX's segment, whose TF gradient is apply_tf's)
            # and, in d_tf, against K2's render(ert=False).  K2's
            # render(ert=False) takes the d_volume of the JAX march's TF
            # (the dot form: no slope at an integer t = i * (R - 1)); the
            # samples where the two rules part are counted, not held.
            v = vol_i.clone().requires_grad_(True)
            t = tf_i.clone().requires_grad_(True)
            composed(v, 4, rays_p, cfg, length, t)[0].square().mean() \
                .backward()
            v1 = vol_i.clone().requires_grad_(True)
            t1 = tf_i.clone().requires_grad_(True)
            P.reset_launch_counts()
            out = PP.render_volume_sharded(v1, t1, lf, cfg, u=u_p)
            out.image.square().mean().backward()
            sync()
            c_rvs = P.launch_counts()
            require(c_rvs["march_segment_fwd"] == 1
                    and c_rvs["march_segment_bwd"] == 1
                    and sum(c_rvs.values()) == 2,
                    f"render_volume_sharded's step launched {c_rvs}")
            for name in ("march_segment_fwd", "march_segment_bwd"):
                kernels[name]["launches"] += c_rvs[name]
            err = float((out.image - want).abs().max())
            require(err <= 2e-4 and torch.equal(out.valid_steps, want_steps),
                    f"render_volume_sharded on {scene}: max |diff| {err} "
                    f"from render(ert=False)")
            _, dv_r, dt_r = step_of(
                lambda *a, **k: P.render(*a, ert=False, **k), vol_i, u_p)
            over = (v1.grad - dv_r).abs() > K2_GRAD_TOL * dv_r.abs().max()
            par[f"{scene}_render_volume_sharded"] = {
                "launches": c_rvs, "max_abs_err": err,
                "valid_steps_equal": True,
                "grad_rel_err_d_tf_vs_render": grads_close(
                    (t1.grad,), (dt_r,), "render_volume_sharded",
                    ("d_tf",))[0],
                "d_volume_vs_render_rel_err": float(
                    (v1.grad - dv_r).abs().max() / dv_r.abs().max()),
                "d_volume_vs_render_voxels_over_tol": int(over.sum())}
            par[f"{scene}_K4"]["grad_rel_err_d_volume_d_tf"] = grads_close(
                (v.grad, t.grad), (v1.grad, t1.grad),
                f"the gradient through 4 segments on {scene}")
            # The same world-size-1 step (K1 and K2 segment on the whole
            # volume's block at 512^2) against the plain segment march on
            # three tiles of 128^2, the cotangent 0 off them: a silhouette
            # corner, a central tile and the tile whose cotangent alone
            # parts the segment's d_volume most from K2's render(ert=False).
            # On them K2's render(ert=False) is held to the plain march too,
            # and the voxels where the segment's TF rule (apply_tf) parts
            # from render's (march_tf) are counted in both pairs.  Rays with
            # a sample on a kink of the shading (kink_free) get no cotangent.
            v4 = vol_i.clone().requires_grad_(True)
            img_s = PP.render_volume_sharded(v4, tf_i, lf, cfg, u=u_p).image
            img_r = P.render(v4, tf_i, lf, cfg, 1.0, u=u_p, ert=False).image
            g_all = 2.0 * img_s.detach() / img_s.numel()
            part = {}
            for r in range(img // 128):
                for c in range(img // 128):
                    g_rc = torch.zeros_like(g_all)
                    blk = (slice(r * 128, (r + 1) * 128),
                           slice(c * 128, (c + 1) * 128))
                    g_rc[blk] = g_all[blk]
                    d_s, = torch.autograd.grad(img_s, v4, g_rc,
                                               retain_graph=True)
                    d_r, = torch.autograd.grad(img_r, v4, g_rc,
                                               retain_graph=True)
                    part[(r, c)] = float((d_s - d_r).abs().max())
            worst = max(part, key=part.get)
            del v4, img_s, img_r, g_rc, d_s, d_r
            picks, blocks, mask = spread_tiles(rays_p.n_samples, 128,
                                               ("corner", "centre"))
            if worst not in picks:
                blk = (slice(worst[0] * 128, (worst[0] + 1) * 128),
                       slice(worst[1] * 128, (worst[1] + 1) * 128))
                picks.append(worst)
                blocks.append(blk)
                mask[blk] = 1.0
            keep = torch.ones((img, img), dtype=torch.bool, device=dev)
            for blk in blocks:
                keep[blk] = kink_free(vol_i, tf_i, *tile_of(rays_p, cfg, blk))
            n_kink = int((~keep).sum())
            require(n_kink <= 0.001 * len(blocks) * 128 * 128,
                    f"{n_kink} rays on a kink of the shading on {scene}")
            v2 = vol_i.clone().requires_grad_(True)
            t2 = tf_i.clone().requires_grad_(True)
            out2 = PP.render_volume_sharded(v2, t2, lf, cfg, u=u_p)
            g_t = 2.0 * out2.image.detach() / out2.image.numel() * mask \
                * keep[..., None]
            out2.image.backward(g_t)
            vp = vol_i.clone().requires_grad_(True)
            tp = tf_i.clone().requires_grad_(True)
            dv_rp, dt_rp = torch.zeros_like(vol_i), torch.zeros_like(tf_i)
            tile_err = 0.0
            t0 = time.perf_counter()
            for blk in blocks:
                rays_b, cfg_b = tile_of(rays_p, cfg, blk)
                acc_p, cnt_p = PV.segment_march_plain(
                    PV.pad_halos(vp, 0, 1), tp, rays_b, cfg_b, 1.0, 0, 1,
                    length)
                img_p, valid_p = PV.compose_segments(
                    acc_p[None], cnt_p[None], rays_b.dirs[..., 0])
                err = float((out2.image[blk] - img_p).detach().abs().max())
                require(err <= 2e-4
                        and torch.equal(out2.valid_steps[blk], valid_p),
                        f"render_volume_sharded on {scene}, tile {blk}: max "
                        f"|diff| {err} from the plain segment march, "
                        f"valid_steps equal "
                        f"{torch.equal(out2.valid_steps[blk], valid_p)}")
                tile_err = max(tile_err, err)
                img_p.backward(g_t[blk])
                d_rp = P.march_diff_bwd_plain(vol_i, tf_i, rays_b, cfg_b, 1.0,
                                              g_t[blk], ert=False)
                dv_rp += d_rp[0]
                dt_rp += d_rp[1]
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            errs = k2_grad_errs((v2.grad, t2.grad), (vp.grad, tp.grad),
                                f"render_volume_sharded on {scene}, tiles "
                                f"{picks} of 128^2")
            seg_fwd_err = max(seg_fwd_err, tile_err)
            seg_bwd_err = max(seg_bwd_err, *errs)
            v3 = vol_i.clone().requires_grad_(True)
            t3 = tf_i.clone().requires_grad_(True)
            P.render(v3, t3, lf, cfg, 1.0, u=u_p, ert=False).image \
                .backward(g_t)
            errs_r = k2_grad_errs((v3.grad, t3.grad), (dv_rp, dt_rp),
                                  f"K2 render(ert=False) on {scene}, tiles "
                                  f"{picks} of 128^2")
            tol = K2_GRAD_TOL * vp.grad.abs().max()
            par[f"{scene}_render_volume_sharded"]["tiles_vs_plain"] = {
                "tiles": picks, "parting_tile": worst,
                "rays_on_shading_kinks": n_kink,
                "parting_tile_max_abs": part[worst],
                "image_max_abs_err": tile_err, "valid_steps_equal": True,
                "k2_segment_rel_err_d_volume_d_tf": errs,
                "k2_render_rel_err_d_volume_d_tf": errs_r,
                "plain_ms_segment_and_render_bwd": plain_ms,
                "d_volume_segment_vs_render_voxels_over_tol_plain": int(
                    ((vp.grad - dv_rp).abs() > tol).sum()),
                "d_volume_segment_vs_render_voxels_over_tol_kernels": int(
                    ((v2.grad - v3.grad).abs() > tol).sum())}
            del v, t, v1, t1, dv_r, dt_r, want, out, over, v2, t2, out2, g_t
            del vp, tp, dv_rp, dt_rp, v3, t3, acc_p, img_p, mask, keep
        vol_n = user_to_internal(scenes["noise"])
        # Each shard's K1 and K2 segment against the plain segment march at
        # 128^2; the reduced window of JAX's side-on test at K = 8.
        cfg_s = cfg.replace(image_shape=(128, 128))
        u_s = torch.rand((128, 128), generator=gen_b, device=dev)
        g_s = torch.rand((128, 128, 4), generator=gen_b, device=dev) - 0.3
        full = PV.segment_length(cfg_s, 1.0)[0]
        shard_cases = []
        for label, lf_c, n, length_c in (
                ("bench", lf, 4, full),
                ("window", torch.tensor([0.1, 0.4, 2.4], device=dev), 8,
                 PV.segment_length(cfg_s, 1.0, full // 4)[0])):
            rays_s = P.make_rays(lf_c, cfg_s, 1.0, u=u_s)
            outs = []
            for k in range(n):
                pad = PV.pad_halos(vol_n, k, n)
                acc, cnt = P.march_segment_fwd(pad, tf_i, rays_s, cfg_s, 1.0,
                                               k, n, length_c)
                t0 = time.perf_counter()
                with torch.no_grad():
                    acc_p, cnt_p = PV.segment_march_plain(
                        pad, tf_i, rays_s, cfg_s, 1.0, k, n, length_c)
                sync()
                plain_fwd_ms = (time.perf_counter() - t0) * 1e3
                err = float((acc - acc_p).abs().max())
                require(err <= 2e-4 and torch.equal(cnt, cnt_p),
                        f"K1 segment {k} of {n} ({label}) at 128^2: max "
                        f"|diff| {err}, counts equal "
                        f"{torch.equal(cnt, cnt_p)}")
                seg_fwd_err = max(seg_fwd_err, err)
                case = {"case": label, "shard": k, "of": n,
                        "length": length_c, "k1_max_abs_err": err,
                        "samples": int(cnt.sum()),
                        "plain_fwd_ms": plain_fwd_ms}
                outs.append((acc, cnt))
                if label == "bench":
                    got = P.march_segment_bwd(pad, tf_i, rays_s, cfg_s, 1.0,
                                              k, n, length_c, acc, g_s)[:2]
                    t0 = time.perf_counter()
                    with torch.enable_grad():
                        pv = pad.clone().requires_grad_(True)
                        tv = tf_i.clone().requires_grad_(True)
                        out_p, _ = PV.segment_march_plain(
                            pv, tv, rays_s, cfg_s, 1.0, k, n, length_c)
                        want_g = torch.autograd.grad(out_p, (pv, tv), g_s)
                    sync()
                    case["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
                    errs = k2_grad_errs(got, want_g,
                                        f"K2 segment {k} of {n} at 128^2")
                    case["k2_rel_err_d_padded_d_tf"] = errs
                    seg_bwd_err = max(seg_bwd_err, *errs)
                    case["k1_ms_128"] = cuda_ms(lambda: P.march_segment_fwd(
                        pad, tf_i, rays_s, cfg_s, 1.0, k, n, length_c), 5)
                    case["k2_ms_128"] = cuda_ms(lambda: P.march_segment_bwd(
                        pad, tf_i, rays_s, cfg_s, 1.0, k, n, length_c, acc,
                        g_s), 5)
                    del pv, tv, out_p, want_g, got
                shard_cases.append(case)
            if label == "window":
                image, _ = PV.compose_segments(
                    torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]), rays_s.dirs[..., 0])
                whole, _ = P.march_diff_fwd(vol_n, tf_i, rays_s, cfg_s, 1.0,
                                            ert=False)
                par["window_distance_from_render"] = float(
                    (image - whole).abs().max())
        par["shards_128"] = shard_cases

        # 4. World size 1 through the other entry points.  Four views: render_views, each view bitwise render's alone; the
        # gradients of view_parallel_grads and train_step_views (both
        # modes) against the serial mean-loss gradient.
        lfs = torch.stack([torch.tensor([math.cos(a) * 2.4, 0.6,
                                         math.sin(a) * 2.4], device=dev)
                           for a in (0.3, 1.1, 1.9, 2.7)])
        u4 = torch.rand((4, img, img), generator=gen_b, device=dev)
        P.reset_launch_counts()
        imgs = PP.render_views(vol_n, tf_i, lfs, cfg, u=u4)
        sync()
        c_views = P.launch_counts()
        require(c_views["march_diff_fwd"] == 4, f"render_views: {c_views}")
        singles = [P.render(vol_n, tf_i, lfs[i], cfg, 1.0, u=u4[i]).image
                   for i in range(4)]
        require(all(torch.equal(imgs[i], singles[i]) for i in range(4)),
                "render_views differs from render of each view alone")
        targets = 0.9 * torch.stack(singles)
        del singles
        v = vol_n.clone().requires_grad_(True)
        t = tf_i.clone().requires_grad_(True)
        loss_s = sum(P.mse_loss(P.render(v, t, lfs[i], cfg, 1.0,
                                         u=u4[i]).image, targets[i])
                     for i in range(4)) / 4
        loss_s.backward()
        serial = (v.grad, t.grad)
        views = {"render_views_bitwise_render": True,
                 "launches_render_views": c_views}
        for label, fn in (
                ("view_parallel_grads", lambda: PP.view_parallel_grads(
                    P.mse_loss, vol_n, tf_i, lfs, targets, cfg, u=u4)),
                ("train_step_views_accum", lambda: PP.train_step_views(
                    P.mse_loss, vol_n, tf_i, lfs, targets, cfg, u=u4,
                    mode="accum")),
                ("train_step_views_shard_map", lambda: PP.train_step_views(
                    P.mse_loss, vol_n, tf_i, lfs, targets, cfg, u=u4,
                    group=dist.group.WORLD))):
            loss, grads = fn()
            views[label] = {
                "loss_rel_err": abs(float(loss) - float(loss_s))
                / float(loss_s),
                "grad_rel_err_d_volume_d_tf": grads_close(grads, serial,
                                                          label)}
            require(views[label]["loss_rel_err"] <= 1e-5,
                    f"{label}: loss {float(loss)} vs {float(loss_s)}")
        del v, t, serial, imgs, targets
        # The shear-warp train step, 2 views at 128^3 / 256^2, against two
        # render_fast steps.
        cfg_sw = cfg.replace(volume_shape=(128,) * 3, image_shape=(256, 256))
        vol_sw = user_to_internal(lambda: P.noise_volume(128, seed=0))
        lfs_sw = lfs[:2]
        with torch.no_grad():
            tg_sw = 0.9 * torch.stack([P.render_fast(
                vol_sw, tf_i, lfs_sw[i], cfg_sw).image for i in range(2)])
        P.reset_launch_counts()
        loss_sw, grads_sw = PP.train_step_views(
            P.mse_loss, vol_sw, tf_i, lfs_sw, tg_sw, cfg_sw,
            sampling_rate=1.0, mode="accum", renderer="shearwarp")
        sync()
        c_sw = P.launch_counts()
        require(c_sw["shear_warp_fwd"] == 2 and c_sw["shear_warp_bwd"] == 2
                and sum(c_sw.values()) == 4,
                f"the shear-warp train step launched {c_sw}")
        kernels["shear_warp_fwd"]["launches"] += 2
        kernels["shear_warp_bwd"]["launches"] += 2
        v = vol_sw.clone().requires_grad_(True)
        t = tf_i.clone().requires_grad_(True)
        (sum(P.mse_loss(P.render_fast(v, t, lfs_sw[i], cfg_sw).image,
                        tg_sw[i]) for i in range(2)) / 2).backward()
        views["train_step_views_shearwarp"] = {
            "launches": c_sw, "grad_rel_err_d_volume_d_tf": grads_close(
                grads_sw, (v.grad, t.grad), "the shear-warp train step")}
        del v, t, vol_sw, grads_sw
        par["views"] = views
        # render_fast_sharded bitwise render_fast; 4 row strips joined
        # bitwise the whole intermediate image.
        with torch.no_grad():
            P.reset_launch_counts()
            f_sh = P.render_fast_sharded(vol_n, tf_i, lf, cfg,
                                         intermediate=576,
                                         planes_per_voxel=2.0)
            sync()
            c_fsh = P.launch_counts()
            require(c_fsh["shear_warp_fwd"] == 1 and sum(c_fsh.values()) == 1,
                    f"render_fast_sharded launched {c_fsh}")
            kernels["shear_warp_fwd"]["launches"] += 1
            f_mono = P.render_fast(vol_n, tf_i, lf, cfg, intermediate=576,
                                   planes_per_voxel=2.0)
            require(torch.equal(f_sh.image, f_mono.image)
                    and torch.equal(f_sh.hit, f_mono.hit),
                    "render_fast_sharded differs from render_fast")
            args = (vol_n, tf_i, lf, cfg, 576, 2.0, 32,
                    SW.shear_warp_march)
            whole = PF._intermediate(*args)[0]
            strips = torch.cat([PF._intermediate(*args, 144 * k, 144)[0]
                                for k in range(4)])
            require(torch.equal(strips, whole),
                    "4 row strips differ from the whole intermediate image")
        par["render_fast_sharded"] = {"bitwise_render_fast": True,
                                      "strips4_bitwise": True,
                                      "launches": c_fsh}
        del f_sh, f_mono, whole, strips

        # 5. Times: K1 and K2 segments per shard and summed over K = 4,
        # beside K1 and K2 without ERT on the whole volume; the entry points'
        # wall times at world size 1 beside render's.
        soa = _ray_soa(rays_p)
        pads = [PV.pad_halos(vol_n, k, 4) for k in range(4)]
        segs = [PV._segment(rays_p, cfg, k, 4, length) for k in range(4)]
        c1 = [torch.zeros((img, img, 2), dtype=torch.int32, device=dev)
              for _ in range(4)]
        fwd = [k1_segment(pads[k], tf_i, soa, segs[k], cfg, 1.0, c1[k])
               for k in range(4)]
        accs = torch.stack([f[0] for f in fwd]).requires_grad_(True)
        image, _ = PV.compose_segments(accs, torch.stack([f[1] for f in fwd]),
                                       dir_x)
        g_accs = torch.autograd.grad(image.square().mean(), accs)[0]
        c2 = [torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
              for _ in range(4)]
        for k in range(4):
            k2_segment(pads[k], tf_i, soa, segs[k], cfg, 1.0, fwd[k][0],
                           g_accs[k], c2[k])
        k1_ms = [cuda_ms(lambda k=k: k1_segment(
            pads[k], tf_i, soa, segs[k], cfg, 1.0), 10) for k in range(4)]
        k2_ms = [cuda_ms(lambda k=k: k2_segment(
            pads[k], tf_i, soa, segs[k], cfg, 1.0, fwd[k][0], g_accs[k]),
            10) for k in range(4)]
        whole_img, whole_steps = P.march_diff_fwd(vol_n, tf_i, rays_p, cfg,
                                                  1.0, ert=False)
        g_whole = 2.0 * whole_img / whole_img.numel()
        k1_sum_ms, k1_whole_ms = cuda_ms_ab(
            lambda: [k1_segment(pads[k], tf_i, soa, segs[k], cfg, 1.0)
                     for k in range(4)],
            lambda: P.march_diff_fwd(vol_n, tf_i, rays_p, cfg, 1.0,
                                     ert=False), 10, warm=2)
        k2_sum_ms, k2_whole_ms = cuda_ms_ab(
            lambda: [k2_segment(pads[k], tf_i, soa, segs[k], cfg, 1.0,
                                    fwd[k][0], g_accs[k]) for k in range(4)],
            lambda: P.march_diff_bwd(vol_n, tf_i, rays_p, cfg, 1.0,
                                     whole_img, g_whole, ert=False),
            10, warm=2)
        blk_bytes = pads[0].numel() * 4
        k1_b, k2_b = [], []
        for k in range(4):
            n_s = int(fwd[k][1].sum())
            n_zero = int(c1[k][..., 0].sum())
            k1_b.append(bound(blk_bytes + R * 16 + ray_bytes + img * img * 24,
                              (n_s - n_zero) * DIFF_SAMPLE_OPS
                              + n_zero * ZERO_OPACITY_OPS))
            n_sc, n_ql = int(c2[k][..., 0].sum()), int(c2[k][..., 1].sum())
            k2_b.append(bound(3 * blk_bytes + R * 32 + ray_bytes
                              + img * img * 40,
                              n_sc * BWD_SAMPLE_OPS
                              + (n_s - n_sc) * QUIET_SAMPLE_OPS
                              + n_ql * QUIET_LIGHT_OPS))
        rvs_ms, render_ms = host_ms_ab(
            lambda: PP.render_volume_sharded(vol_n, tf_i, lf, cfg, u=u_p),
            lambda: P.render(vol_n, tf_i, lf, cfg, 1.0, u=u_p, ert=False),
            5)
        views_ms, renders_ms = host_ms_ab(
            lambda: PP.render_views(vol_n, tf_i, lfs, cfg, u=u4),
            lambda: [P.render(vol_n, tf_i, lfs[i], cfg, 1.0, u=u4[i])
                     for i in range(4)], 3)
        shard_128 = [c for c in shard_cases if c["case"] == "bench"]
        times = {
            "k1_segment_ms_per_shard": k1_ms,
            "k1_segment_ms_sum_k4": k1_sum_ms,
            "k1_whole_ert_false_ms": k1_whole_ms,
            "k1_segment_bound_ms_per_shard": [b[0] for b in k1_b],
            "k2_segment_ms_per_shard": k2_ms,
            "k2_segment_ms_sum_k4": k2_sum_ms,
            "k2_whole_ert_false_ms": k2_whole_ms,
            "k2_segment_bound_ms_per_shard": [b[0] for b in k2_b],
            "samples_per_shard": [int(f[1].sum()) for f in fwd],
            "samples_whole": int((whole_steps - 1).sum()),
            "render_volume_sharded_ms": rvs_ms,
            "render_ert_false_ms": render_ms,
            "render_views_b4_ms": views_ms, "render_4_views_ms": renders_ms}
        par["times"] = times
        for name, ms, b, err, key in (
                ("march_segment_fwd", k1_ms, k1_b, seg_fwd_err, "k1"),
                ("march_segment_bwd", k2_ms, k2_b, seg_bwd_err, "k2")):
            plain = "plain_fwd_ms" if key == "k1" else "plain_bwd_ms"
            kernels[name].update(
                max_abs_err=err, ms=statistics.mean(ms),
                bound_ms=statistics.mean(x[0] for x in b), bound_by=b[0][1],
                ms_sum_k4=times[f"{key}_segment_ms_sum_k4"],
                ms_whole_ert_false=times[f"{key}_whole_ert_false_ms"],
                bound_ms_sum_k4=sum(x[0] for x in b),
                plain_ms=statistics.mean(c[plain] for c in shard_128),
                ms_128=statistics.mean(c[f"{key}_ms_128"]
                                       for c in shard_128),
                plain_ms_note="segment_march_plain (K2: its autograd) on "
                              "one shard's 128^2 rays, host clock, beside "
                              "ms_128, the kernel on those rays; ms and "
                              "bound_ms per shard of 4 at 512^2")
        kernels["march_segment_bwd"]["max_abs_err_is"] = \
            "max |diff| / max |g| per gradient tensor"
        del pads, fwd, accs, g_accs, whole_img, g_whole, c1, c2

        # 6. The camera gradient through the segments (K2's segment camera
        # instantiation): per shard its 12 per-ray sums and the ray tensors'
        # cotangents against the plain segment march, at 128^2 on noise (an
        # outer and an inner shard of 4) and on the golden sphere (all 4
        # shards); d_look_from of render_volume_sharded at world size 1
        # against the plain segment's and against the 4 segments composed;
        # at 512^2 the step with and without the camera gradient.
        t_cam = time.perf_counter()
        from differender_tpu_torch.parallel.volume_sharding import \
            segment_cotangents_plain
        gen_s = torch.Generator(device=dev)     # this check's draws
        gen_s.manual_seed(5)

        def rel_max(got, want):
            """max |got - want| and max |want|."""
            return (float((got - want).abs().max()),
                    float(want.abs().max()))

        def segment_camera_case(vol_c, tf_c, cfg_c, lf_c, u_c, g_c, sr, n,
                                shards, label):
            """See 6. above.  Rays with a sample on a kink of the shading
            (kink_free) get no cotangent.  Returns the case's record."""
            H, W = cfg_c.image_shape
            length_c = PV.segment_length(cfg_c, sr)[0]
            rays_c = P.make_rays(lf_c, cfg_c, sr, u=u_c)
            keep = kink_free(vol_c, tf_c, rays_c, cfg_c)
            n_kink = int((~keep).sum())
            require(n_kink <= 0.001 * H * W,
                    f"{n_kink} rays on a kink of the shading on {label}")
            g_m = g_c * keep[..., None]
            rec = {"rays_on_shading_kinks": n_kink, "shards": []}
            plain_ms = []
            for k in shards:
                pad = PV.pad_halos(vol_c, k, n)
                acc, cnt = P.march_segment_fwd(pad, tf_c, rays_c, cfg_c, sr,
                                               k, n, length_c)
                sums = torch.zeros((H, W, 12), device=dev)
                before = P.launch_counts()["march_segment_bwd.camera"]
                d_p, d_t, _ = P.march_segment_bwd(
                    pad, tf_c, rays_c, cfg_c, sr, k, n, length_c, acc, g_m,
                    sums=sums)
                require(P.launch_counts()["march_segment_bwd.camera"]
                        == before + 1,
                        f"{label} shard {k}: no camera launch")
                d_p0, d_t0, _ = P.march_segment_bwd(
                    pad, tf_c, rays_c, cfg_c, sr, k, n, length_c, acc, g_m)
                same = []
                for got_k, want_k, what in ((d_p, d_p0, "d_padded"),
                                            (d_t, d_t0, "d_tf")):
                    e, m = rel_max(got_k, want_k)
                    require(e <= K2_GRAD_TOL * m,
                            f"{label} shard {k}: K2 segment camera's {what} "
                            f"against the default's, max |diff| {e} > "
                            f"{K2_GRAD_TOL} * {m}")
                    same.append(e / m if m > 0 else 0.0)
                require(bool(torch.isfinite(sums).all()),
                        f"{label} shard {k}: K2's sums not finite")
                sync()
                t0 = time.perf_counter()
                ref = ray_sums(segment_cotangents_plain(
                    pad, tf_c, rays_c, cfg_c, sr, k, n, length_c, g_m),
                    (H, W))
                sync()
                plain_ms.append((time.perf_counter() - t0) * 1e3)
                sum_errs = []
                for i, what in enumerate("PSLV"):
                    e, m = rel_max(sums[..., 3 * i:3 * i + 3],
                                   ref[..., 3 * i:3 * i + 3])
                    require(e <= CAMERA_SUM_TOL * m,
                            f"{label} shard {k}: K2's {what} per ray, max "
                            f"|diff| {e} > {CAMERA_SUM_TOL} * {m}")
                    sum_errs.append(e / m if m > 0 else 0.0)
                lv = leaves_of(rays_c)
                acc_l, _ = PP.segment_march(pad, tf_c, with_leaves(rays_c, lv),
                                            cfg_c, sr, k, n, length_c)
                got = torch.autograd.grad(acc_l, lv, g_m)
                lb = leaves_of(rays_c)
                with torch.enable_grad():
                    acc_p, _ = PV.segment_march_plain(
                        pad, tf_c, with_leaves(rays_c, lb), cfg_c, sr, k, n,
                        length_c)
                want = torch.autograd.grad(acc_p, lb, g_m)
                ray_errs = {}
                for what, g_k, w_k in zip(("origin", "dirs", "entry",
                                           "exit"), got, want):
                    e, m = rel_max(g_k, w_k)
                    require(bool(torch.isfinite(g_k).all())
                            and e <= CAMERA_RAY_TOL * m,
                            f"{label} shard {k}: the {what} cotangent, max "
                            f"|diff| {e} > {CAMERA_RAY_TOL} * {m}")
                    ray_errs[what] = e / m if m > 0 else 0.0
                rec["shards"].append({
                    "shard": k, "of": n, "samples": int(cnt.sum()),
                    "rel_err_P_S_L_V": sum_errs,
                    "rel_err_ray_tensors": ray_errs,
                    "k2_camera_vs_default_rel_d_padded_d_tf": same,
                    "plain_cotangents_ms": plain_ms[-1]})
                del pad, acc, sums, d_p, d_t, d_p0, d_t0, ref, got, want
            # d_look_from at world size 1, against the plain segment's and
            # against the n segments composed.
            lf_k = lf_c.clone().requires_grad_()
            P.reset_launch_counts()
            out_k = PP.render_volume_sharded(vol_c, tf_c, lf_k, cfg_c,
                                             sampling_rate=sr, u=u_c)
            torch.sum(out_k.image * g_m).backward()
            sync()
            c_k = P.launch_counts()
            require(c_k["march_segment_fwd"] == 1
                    and c_k["march_segment_bwd"] == 1
                    and c_k["march_segment_bwd.camera"] == 1,
                    f"{label}: the camera step launched {c_k}")
            lf_p = lf_c.clone().requires_grad_()
            rays_pl = P.make_rays(lf_p, cfg_c, sr, u=u_c)
            acc_p, cnt_p = PV.segment_march_plain(
                PV.pad_halos(vol_c, 0, 1), tf_c, rays_pl, cfg_c, sr, 0, 1,
                length_c)
            img_p, _ = PV.compose_segments(acc_p[None], cnt_p[None],
                                           rays_pl.dirs[..., 0])
            lf_plain, = torch.autograd.grad(torch.sum(img_p * g_m), lf_p)
            lf_n = lf_c.clone().requires_grad_()
            rays_n = P.make_rays(lf_n, cfg_c, sr, u=u_c)
            outs = [PP.segment_march(PV.pad_halos(vol_c, k, n), tf_c, rays_n,
                                     cfg_c, sr, k, n, length_c)
                    for k in range(n)]
            img_n, _ = PV.compose_segments(
                torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]), rays_n.dirs[..., 0])
            lf_segs, = torch.autograd.grad(torch.sum(img_n * g_m), lf_n)
            norm = float(lf_plain.norm())
            err = float((lf_k.grad - lf_plain).abs().max()) / norm
            err_n = float((lf_segs - lf_k.grad).abs().max()) / norm
            require(bool(torch.isfinite(lf_k.grad).all()) and norm > 0
                    and err <= CAMERA_TOL and err_n <= CAMERA_TOL,
                    f"{label}: d_look_from {lf_k.grad.tolist()}, plain "
                    f"{lf_plain.tolist()}, {n} segments {lf_segs.tolist()}")
            rec.update(launches=c_k, d_look_from=lf_k.grad.tolist(),
                       d_look_from_plain=lf_plain.tolist(),
                       d_look_from_rel_err=err,
                       d_look_from_segments=lf_segs.tolist(),
                       d_look_from_segments_rel_err=err_n,
                       plain_ms=statistics.mean(plain_ms))
            return rec

        cam = {}
        u_c = torch.rand((128, 128), generator=gen_s, device=dev)
        g_c = torch.rand((128, 128, 4), generator=gen_s, device=dev) - 0.3
        cam["noise_128"] = segment_camera_case(
            vol_n, tf_i, cfg_s, lf, u_c, g_c, 1.0, 4, (0, 1),
            "segment camera, noise 128^2")
        g_sph = torch.rand((16, 16, 4), generator=gen_s, device=dev) - 0.3
        cam["sphere"] = segment_camera_case(
            sphere, gtf, gcfg, glf, None, g_sph, 0.8, 4, range(4),
            "segment camera, sphere")
        # At 512^2: the world-size-1 step with and without the camera
        # gradient, called in turn; the main path's launches.
        v_leaf = vol_n.clone().requires_grad_()
        t_leaf = tf_i.clone().requires_grad_()
        lf_leaf = lf.clone().requires_grad_()

        def rvs_step(look_from):
            v_leaf.grad = t_leaf.grad = lf_leaf.grad = None
            PP.render_volume_sharded(v_leaf, t_leaf, look_from, cfg,
                                     u=u_p).image.square().mean().backward()

        P.reset_launch_counts()
        rvs_step(lf_leaf)
        sync()
        c_cam = P.launch_counts()
        require(c_cam["march_segment_fwd"] == 1
                and c_cam["march_segment_bwd"] == 1
                and c_cam["march_segment_bwd.camera"] == 1
                and sum(c_cam.values()) == 3
                and bool(torch.isfinite(lf_leaf.grad).all()),
                f"the sharded camera step launched {c_cam}")
        for name in ("march_segment_fwd", "march_segment_bwd"):
            kernels[name]["launches"] += c_cam[name]
        kernels["march_segment_bwd_camera"]["launches"] += c_cam[
            "march_segment_bwd.camera"]
        step_ms, step_ms_cam = host_ms_ab(lambda: rvs_step(lf),
                                          lambda: rvs_step(lf_leaf), 5)
        # K2's segment camera instantiation at the step's rays (one segment
        # over the whole volume), timed beside the default one; its bound
        # counts the camera's operations per scattering sample over the
        # owned samples.
        soa = _ray_soa(rays_p)
        seg1 = PV._segment(rays_p, cfg, 0, 1, length)
        pad1 = PV.pad_halos(vol_n, 0, 1)
        acc1, cnt1 = k1_segment(pad1, tf_i, soa, seg1, cfg, 1.0)
        g1 = 2.0 * acc1 / acc1.numel()
        sums1 = torch.empty((img, img, 12), device=dev)
        k2_ms_def, k2_ms_cam = cuda_ms_ab(
            lambda: k2_segment(pad1, tf_i, soa, seg1, cfg, 1.0, acc1, g1),
            lambda: k2_segment(pad1, tf_i, soa, seg1, cfg, 1.0, acc1, g1,
                                   sums=sums1), 10, warm=2)
        cc = torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
        k2_segment(pad1, tf_i, soa, seg1, cfg, 1.0, acc1, g1, cc, sums1)
        n_s = int(cnt1.sum())
        n_sc, n_ql = int(cc[..., 0].sum()), int(cc[..., 1].sum())
        b_cam = bound(3 * pad1.numel() * 4 + R * 32 + ray_bytes
                      + img * img * (40 + 48),
                      n_sc * (BWD_SAMPLE_OPS + CAMERA_POSITION_OPS)
                      + (n_s - n_sc) * QUIET_SAMPLE_OPS + n_ql * QUIET_LIGHT_OPS
                      + n_s * CAMERA_SUM_OPS)
        # The same step held to the plain segment march on the three tiles
        # of 128^2 that 1./2. picked on noise (a silhouette corner, a central
        # tile, the parting tile), the step's cotangent 0 off them and on
        # rays with a sample on a kink of the shading: K2's segment camera
        # sums and the ray tensors' cotangents against the plain segment's
        # on the tiles' rays (marched as one bundle of 3 * 128 x 128 rays),
        # and the step's d_look_from against the plain one pulled through
        # the ray setup.
        t_tiles = time.perf_counter()
        picks = [tuple(rc) for rc in
                 par["noise_render_volume_sharded"]["tiles_vs_plain"]["tiles"]]
        blocks = [(slice(r * 128, (r + 1) * 128),
                   slice(c * 128, (c + 1) * 128)) for r, c in picks]

        def on_blocks(x):
            return torch.cat([x[blk] for blk in blocks])

        def blocks_of(rays_f):
            return rays_f._replace(
                dirs=on_blocks(rays_f.dirs), entry=on_blocks(rays_f.entry),
                exit=on_blocks(rays_f.exit),
                n_samples=on_blocks(rays_f.n_samples))

        rays_t = blocks_of(rays_p)
        cfg_t = cfg.replace(image_shape=tuple(rays_t.n_samples.shape))
        keep_t = kink_free(vol_n, tf_i, rays_t, cfg_t)
        n_kink = int((~keep_t).sum())
        require(n_kink <= 0.001 * keep_t.numel(),
                f"{n_kink} rays on a kink of the shading on the camera "
                f"step's tiles {picks}")
        keep = torch.zeros((img, img), dtype=torch.bool, device=dev)
        for i, blk in enumerate(blocks):
            keep[blk] = keep_t[i * 128:(i + 1) * 128]
        g_t = g1 * keep[..., None]
        sums_t = torch.zeros((img, img, 12), device=dev)
        P.march_segment_bwd(pad1, tf_i, rays_p, cfg, 1.0, 0, 1, length, acc1,
                            g_t, sums=sums_t)
        sync()
        t0 = time.perf_counter()
        ref = ray_sums(segment_cotangents_plain(
            pad1, tf_i, rays_t, cfg_t, 1.0, 0, 1, length, on_blocks(g_t)),
            cfg_t.image_shape)
        sync()
        tiles_plain_ms = (time.perf_counter() - t0) * 1e3
        got_s = on_blocks(sums_t)
        tile_sum_errs = []
        for i, what in enumerate("PSLV"):
            e, m = rel_max(got_s[..., 3 * i:3 * i + 3],
                           ref[..., 3 * i:3 * i + 3])
            require(m > 0 and e <= CAMERA_SUM_TOL * m,
                    f"the camera step's tiles {picks}: K2's {what} per ray, "
                    f"max |diff| {e} > {CAMERA_SUM_TOL} * {m}")
            tile_sum_errs.append(e / m)
        del ref, got_s, sums_t
        lv = leaves_of(rays_p)
        acc_l, _ = PP.segment_march(pad1, tf_i, with_leaves(rays_p, lv), cfg,
                                    1.0, 0, 1, length)
        got = torch.autograd.grad(acc_l, lv, g_t)
        del acc_l
        lf_p = lf.clone().requires_grad_()
        rays_lf = blocks_of(P.make_rays(lf_p, cfg, 1.0, u=u_p))
        lb = leaves_of(rays_lf)
        with torch.enable_grad():
            acc_p, _ = PV.segment_march_plain(
                pad1, tf_i, with_leaves(rays_t, lb), cfg_t, 1.0, 0, 1,
                length)
        want = torch.autograd.grad(acc_p, lb, on_blocks(g_t))
        del acc_p
        tile_ray_errs = {}
        for i, what in enumerate(("origin", "dirs", "entry", "exit")):
            g_k = got[i] if i == 0 else on_blocks(got[i])
            e, m = rel_max(g_k, want[i])
            off = 0.0
            if i > 0:
                rest = got[i].clone()
                for blk in blocks:
                    rest[blk] = 0.0
                off = float(rest.abs().max())
            require(bool(torch.isfinite(got[i]).all()) and m > 0
                    and e <= CAMERA_RAY_TOL * m and off == 0.0,
                    f"the camera step's tiles {picks}: the {what} "
                    f"cotangent, max |diff| {e} > {CAMERA_RAY_TOL} * {m}, "
                    f"or {off} off the tiles")
            tile_ray_errs[what] = e / m
        lf_plain, = torch.autograd.grad(
            (rays_lf.origin, rays_lf.dirs, rays_lf.entry, rays_lf.exit),
            lf_p, want)
        lf_k = lf.clone().requires_grad_()
        PP.render_volume_sharded(vol_n, tf_i, lf_k, cfg,
                                 u=u_p).image.backward(g_t)
        norm = float(lf_plain.norm())
        tile_lf_err = float((lf_k.grad - lf_plain).abs().max()) / norm
        require(bool(torch.isfinite(lf_k.grad).all()) and norm > 0
                and tile_lf_err <= CAMERA_TOL,
                f"the camera step's d_look_from on the tiles {picks}: "
                f"{lf_k.grad.tolist()} against the plain "
                f"{lf_plain.tolist()}")
        cam["step_512_tiles_vs_plain"] = {
            "tiles": picks, "rays_on_shading_kinks": n_kink,
            "rel_err_P_S_L_V": tile_sum_errs,
            "rel_err_ray_tensors": tile_ray_errs,
            "d_look_from": lf_k.grad.tolist(),
            "d_look_from_plain": lf_plain.tolist(),
            "d_look_from_rel_err": tile_lf_err,
            "plain_cotangents_ms": tiles_plain_ms,
            "seconds": time.perf_counter() - t_tiles}
        del lv, got, lf_p, rays_lf, lb, want, lf_k, rays_t, keep_t, keep, g_t
        res_cam = {k: v for k, v in ptxas_of(
            "march_bwd.cu", ["march_diff_bwd_kernel"]).items()
            if "Lb0ELb1ELb1EE" in k}
        require(len(res_cam) == 2,
                f"the segment camera instantiations' ptxas report: {res_cam}")
        cam_errs = [max(max(s["rel_err_P_S_L_V"]),
                        max(s["rel_err_ray_tensors"].values()))
                    for c in (cam["noise_128"], cam["sphere"])
                    for s in c["shards"]]
        cam.update(
            step_launches=c_cam, grad_step_ms=step_ms,
            grad_step_ms_camera=step_ms_cam, k2_segment_ms=k2_ms_def,
            k2_segment_camera_ms=k2_ms_cam, samples_whole=n_s,
            samples_scattering=n_sc, bound_ms_camera=b_cam[0],
            bound_by_camera=b_cam[1], resources=res_cam,
            seconds=time.perf_counter() - t_cam)
        par["camera"] = cam
        kernels["march_segment_bwd_camera"].update(
            max_abs_err=max(cam_errs + [c["d_look_from_rel_err"]
                                        for c in (cam["noise_128"],
                                                  cam["sphere"])]
                            + tile_sum_errs + list(tile_ray_errs.values())
                            + [tile_lf_err]),
            ms=k2_ms_cam, ms_default=k2_ms_def, bound_ms=b_cam[0],
            bound_by=b_cam[1], plain_ms=cam["noise_128"]["plain_ms"],
            grad_step_ms_camera=step_ms_cam, grad_step_ms=step_ms,
            resources=res_cam,
            max_abs_err_is="max |diff| / max |plain| of the per-ray sums, "
                           "the ray tensors' cotangents and d_look_from "
                           "(its norm)",
            plain_ms_note="segment_cotangents_plain on one shard's 128^2 "
                          "rays (its taps and autograd), host clock; ms at "
                          "the 512^2 step's rays, one segment")
        del v_leaf, t_leaf, lf_leaf, pad1, acc1, g1, sums1, cc
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "parallel", "cases": par, "volume": res, "image": img,
          "length": length, "tolerance_image": 2e-4,
          "tolerance_grad": K2_GRAD_TOL,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # -- 9j. utilities: io, profiling, checkpoints, TorchRaycaster ----------
    t_phase = time.perf_counter()
    import importlib
    import tempfile

    from differender_tpu_torch import io as PIO
    from differender_tpu_torch import profiling as PPR
    libs = {}
    for mod in ("PIL", "matplotlib"):
        try:
            importlib.import_module(mod)
            libs[mod] = True
        except ImportError:
            libs[mod] = False
    print(f"utilities: PIL imports {libs['PIL']}, matplotlib imports "
          f"{libs['matplotlib']}", flush=True)
    util = {"imports": libs}
    scratch = tempfile.mkdtemp(prefix="chip_smoke_util_")
    try:
        # load_raw_volume of a uint8 256^3 file (every byte value): on the
        # card, bitwise numpy's f32 / 255 on the host.  A divisor given as
        # a Python number is not: torch multiplies by its reciprocal there.
        raw = np.random.default_rng(7).integers(0, 256, res ** 3,
                                                dtype=np.uint8)
        raw[:256] = np.arange(256, dtype=np.uint8)
        raw_path = os.path.join(scratch, "volume.raw")
        raw.tofile(raw_path)
        v_raw = PIO.load_raw_volume(raw_path, (res, res, res))
        want_raw = np.ascontiguousarray(np.swapaxes(
            raw.reshape(res, res, res).astype(np.float32) / np.float32(255),
            0, 1))
        require(v_raw.is_cuda and np.array_equal(v_raw.cpu().numpy(),
                                                 want_raw),
                "load_raw_volume differs from numpy's / 255")
        by_scalar = (torch.from_numpy(raw).to(dev).float() / 255).cpu()
        util["load_raw_volume"] = {
            "bitwise_numpy": True, "shape": list(v_raw.shape),
            "scalar_divisor_bitwise": bool(np.array_equal(
                by_scalar.numpy(), raw.astype(np.float32) / np.float32(255)))}
        del raw, v_raw, want_raw, by_scalar
        # One trace around one render and one raycast_nondiff names K1 and
        # K3, and the annotation.
        vol_n = user_to_internal(scenes["noise"])
        trace_dir = os.path.join(scratch, "trace")
        with PPR.trace(trace_dir):
            with PPR.annotate("chip_smoke-render"):
                P.render(vol_n, tf_i, lf, cfg)
            P.render_nondiff(vol_n, tf_i, lf, cfg)
            sync()
        text = "".join(open(os.path.join(trace_dir, f)).read()
                       for f in os.listdir(trace_dir))
        named = {k: k + "_kernel" in text
                 for k in ("march_diff_fwd", "march_nondiff")}
        annotated = "chip_smoke-render" in text
        require(all(named.values()) and annotated,
                f"the trace names {named}, the annotation {annotated}")
        util["trace"] = {"names": named, "bytes": len(text),
                         "annotated": annotated}
        del text
        # A checkpoint of a CUDA tensor, an AdamW state and a CUDA
        # generator's state: restored, each continues as the original.
        w = torch.rand((64, 64), generator=gen_b, device=dev)
        w.requires_grad_()
        opt_w = torch.optim.AdamW([w], lr=1e-2)
        g_gen = torch.Generator(device=dev)
        g_gen.manual_seed(11)
        for _ in range(3):
            w.grad = torch.rand(w.shape, generator=g_gen, device=dev)
            opt_w.step()
        ckpt = os.path.join(scratch, "ckpt.pkl")
        PIO.save_checkpoint(ckpt, {"w": w, "opt": opt_w.state_dict(),
                                   "gen": g_gen.get_state()}, step=3)
        state, step_ck = PIO.load_checkpoint(ckpt)
        w2 = PIO.checkpoint_tensors(state["w"], dev).requires_grad_()
        opt_w2 = torch.optim.AdamW([w2], lr=1e-2)
        opt_w2.load_state_dict(PIO.checkpoint_tensors(state["opt"]))
        g_gen2 = torch.Generator(device=dev)
        g_gen2.set_state(PIO.checkpoint_tensors(state["gen"]))
        for _ in range(2):
            gr = torch.rand(w.shape, generator=g_gen, device=dev)
            require(torch.equal(gr, torch.rand(w.shape, generator=g_gen2,
                                               device=dev)),
                    "the restored generator draws otherwise")
            w.grad, w2.grad = gr, gr.clone()
            opt_w.step()
            opt_w2.step()
        require(step_ck == 3 and torch.equal(w, w2),
                "the restored AdamW continues otherwise")
        util["checkpoint"] = {"round_trip": True, "step": step_ck}
        del w, w2, opt_w, opt_w2, state
        # TorchRaycaster at the bench: forward bitwise Raycaster's with its
        # draw (the same K1 launch), gradients within K2_GRAD_TOL (K2's f32
        # atomics add in another order each launch); raycast_fast at the
        # viewer bitwise Raycaster.raycast_fast, its K0 launches counted.
        trc = P.TorchRaycaster((res, res, res), (img, img), R,
                               sampling_rate=1.0, jitter=True,
                               max_samples=512, seed=0)
        vol_user = P.volume_from_internal(vol_n)[None]
        v_t = vol_user.clone().requires_grad_()
        t_t = tf_user.clone().requires_grad_()
        P.reset_launch_counts()
        img_t = trc(v_t, t_t, lf)
        img_t.square().mean().backward()
        sync()
        c_trc = P.launch_counts()
        require(c_trc["march_diff_fwd"] == 1 and c_trc["march_diff_bwd"] == 1,
                f"TorchRaycaster's step launched {c_trc}")
        kernels["march_diff_fwd"]["launches"] += 1
        kernels["march_diff_bwd"]["launches"] += 1
        v_r = vol_user.clone().requires_grad_()
        t_r = tf_user.clone().requires_grad_()
        img_r = rc(v_r, t_r, lf, u=trc._last_u)
        img_r.square().mean().backward()
        require(torch.equal(img_t, img_r),
                "TorchRaycaster's image differs from Raycaster's")
        util["torch_raycaster"] = {
            "launches": c_trc, "image_bitwise_raycaster": True,
            "grad_rel_err_d_volume_d_tf": grads_close(
                (v_t.grad, t_t.grad), (v_r.grad, t_r.grad),
                "TorchRaycaster against Raycaster")}
        del v_t, t_t, v_r, t_r, img_t, img_r
        syn = torch.from_numpy(P.synthetic_volume(res)).to(dev)[None]
        trc_v = P.TorchRaycaster((res, res, res), (800, 800), R,
                                 sampling_rate=16.0, jitter=False)
        rc_v = P.Raycaster((res, res, res), (800, 800), R,
                           sampling_rate=16.0, jitter=False)
        lf_v = torch.tensor([0.0, 1.0, -2.3], device=dev)
        P.reset_launch_counts()
        fast_t = trc_v.raycast_fast(syn, tf_user, lf_v)
        sync()
        c_fast = P.launch_counts()
        require(c_fast["shear_warp_fwd"] == 1 and sum(c_fast.values()) == 1
                and not fast_t.requires_grad
                and torch.equal(fast_t, rc_v.raycast_fast(syn, tf_user,
                                                          lf_v)),
                f"TorchRaycaster.raycast_fast: {c_fast}")
        kernels["shear_warp_fwd"]["launches"] += 1
        util["torch_raycaster"].update(raycast_fast_bitwise=True,
                                       raycast_fast_launches=c_fast)
        del syn, fast_t, trc, trc_v, rc_v
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    emit({"phase": "utilities", "cases": util,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # -- 9k. examples: the port's example scripts on the card ----------------
    t_phase = time.perf_counter()
    from differender_tpu_torch.examples import interactive_viewer as ex_view
    from differender_tpu_torch.examples import optimize_tf as ex_tf
    from differender_tpu_torch.examples import render_nondiff as ex_rn
    exs = {}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        # render_nondiff at its defaults (800^2, sampling rate 16, the 256^3
        # synthetic volume, 4 strips): bitwise render_nondiff on its inputs.
        a_rn = ex_rn.parser().parse_args(["--out", os.path.join(
            out_dir, "render.png")])
        P.reset_launch_counts()
        o_rn = ex_rn.run(a_rn)
        sync()
        c_rn = P.launch_counts()
        require(c_rn["march_nondiff"] == 4 and c_rn["cell_minmax"] == 1
                and c_rn["cell_distance"] == 1,
                f"render_nondiff.run launched {c_rn}")
        add_launches(c_rn, ("march_nondiff", "cell_minmax", "cell_distance"))
        vol_e, tf_e, lf_e, cfg_e = ex_rn.scene(a_rn)
        require(torch.equal(o_rn["image"], P.render_nondiff(
            vol_e, tf_e, lf_e, cfg_e, a_rn.sampling_rate).image),
            "render_nondiff.run differs from render_nondiff")
        exs["render_nondiff"] = {"launches": c_rn, "bitwise": True,
                                 "image": list(o_rn["image"].shape),
                                 "mean_alpha": float(
                                     o_rn["image"][..., 3].mean())}
        del vol_e
        # optimize_tf backward for 5 iterations at its default widths: the
        # loss falls; one K1 and one K2 a step, one K1 a logged render.
        a_tf = ex_tf.parser().parse_args(["backward", "--iterations", "5",
                                          "--results", out_dir])
        P.reset_launch_counts()
        t0 = time.perf_counter()
        o_tf = ex_tf.run(a_tf)
        sync()
        tf_s = time.perf_counter() - t0
        c_tf = P.launch_counts()
        tf_only = c_tf["march_diff_bwd.tf_only"]
        n_log = len(o_tf["logged"])
        require(o_tf["losses"][-1] < o_tf["losses"][0]
                and all(math.isfinite(x) for x in o_tf["losses"]),
                f"optimize_tf: the loss did not fall: {o_tf['losses']}")
        require(c_tf["march_diff_bwd"] == 5 and tf_only == 5
                and c_tf["march_diff_fwd"] == 5 + n_log
                and c_tf["march_nondiff"] == 1,
                f"optimize_tf.run launched {c_tf} ({tf_only} TF-only K2) "
                f"with {n_log} logged")
        add_launches(c_tf, ("march_diff_fwd", "march_diff_bwd",
                            "march_nondiff", "cell_minmax", "cell_distance"))
        exs["optimize_tf"] = {"launches": c_tf, "tf_only": tf_only,
                              "losses": o_tf["losses"],
                              "logged": n_log, "seconds": tf_s,
                              "tf_l1": o_tf["tf_l1"]}
        exs["tf_only_k2"] = tf_only_k2(P, dev, res)
        kernels["march_diff_bwd"]["launches"] += sum(
            c["launches"] for c in exs["tf_only_k2"].values())
        # interactive_viewer, 3 frames without its server.
        a_v = ex_view.parser().parse_args(["--frames", "3"])
        P.reset_launch_counts()
        o_v = ex_view.run(a_v)
        sync()
        c_v = P.launch_counts()
        require(len(o_v["frames"]) == 3 and c_v["march_nondiff"] == 3
                and c_v["cell_minmax"] == 1
                and all(bool(torch.isfinite(f).all()) for f in o_v["frames"]),
                f"interactive_viewer.run launched {c_v}")
        add_launches(c_v, ("march_nondiff", "cell_minmax", "cell_distance"))
        exs["interactive_viewer"] = {"frames": 3, "launches": c_v}
        # The files, where PIL and matplotlib import.
        written = []
        if libs["PIL"] and libs["matplotlib"]:
            ex_rn.write(a_rn, o_rn)
            ex_tf.write(a_tf, o_tf)
            written = sorted(os.listdir(out_dir))
        if libs["PIL"]:
            pngs = [ex_view.frame_png(f) for f in o_v["frames"]]
            written.append(f"viewer: {len(pngs)} PNG frames, "
                           f"{sum(map(len, pngs))} bytes")
        exs["files_written"] = written
        del o_rn, o_tf, o_v
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "examples", "cases": exs,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # -- 9l. view_batch: the ground truth's views in one K3 launch ----------
    t_phase = time.perf_counter()
    vb = view_batch(P, dev, info.ptxas.get("march.cu", []))
    emit({"phase": "view_batch", "cases": vb,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    kernels["march_nondiff"]["launches"] += sum(
        c["launches"]["march_nondiff"] for k, c in vb.items()
        if k != "resources")

    # -- 9m. diff_batch: the fitted views in one K1 launch ------------------
    t_phase = time.perf_counter()
    db = diff_batch(P, dev, info.ptxas.get("march.cu", []))
    emit({"phase": "diff_batch", "cases": db,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    for k, c in db.items():
        if k != "resources":
            kernels["march_diff_fwd"]["launches"] += 1

    # -- 10. kernels line and the contract line ---------------------------------
    for name, k in kernels.items():
        require(k["launches"] > 0, f"{name} was never launched on its path")
    emit({"kernels": [dict(name=name, max_abs_diff=k["max_abs_err"], **k)
                      for name, k in kernels.items()],
          "nvidia_smi": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
