#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
     and print the registers and spills ptxas gave each instance of the
     tensor-core kernels (``matmul_2d.cu``, ``flash_attention.cu``,
     ``ssd_intra.cu``) and of the 16-byte-access ones (``rmsnorm.cu``,
     ``affine_2d.cu``, ``chain_diag.cu``, ``chain_project.cu``,
     ``rope.cu``, ``chain_fixedpoint.cu``, ``chain_matrix.cu``), and the
     instructions in the SASS that each design rests on: wgmma and TMA
     loads (``HGMMA``, ``UTMALDG``) in the first three libraries, 128-bit
     global loads and stores (``LDG.E.128``, ``STG.E.128``) in every
     instance of the 16-byte kernels (``rmsnorm_vec_kernel``;
     ``vecadd_vec_kernel``, ``affine_flat_kernel``, ``affine_col_kernel``;
     ``chain_diag_vec_kernel``; ``chain_project_vec_kernel``,
     ``chain_project_batch_vec_kernel``; ``rope_vec_kernel``;
     ``chain_matrix_batch_q_vec_kernel``,
     ``chain_diag_batch_q_vec_kernel``; ``chain_matrix_batch_vec_kernel``),
     each counted inside its own ``Function :`` section of ``cuobjdump
     -sass`` (none may lack one);
  3. serve (affine): 1024 requests from the affine template pool
     (lognormal sizes from 1024 to 262144 points, median 16384) through
     ``GeometryServer`` on the GPU -- one warm flush, then three rounds
     of submitting all 1024 and one timed flush (submit and flush timed
     apart) -- then every request through per-request
     ``TransformChain.apply``.  Kept as it was, so its series stays
     comparable;
  4. serve (mixed): the main path, the same run over the full
     ``TEMPLATES`` pool -- the JAX launcher's default mix, about 3/11 of
     the requests projective -- with per-request ``project`` for the
     projective requests and ``apply`` for the rest; in phases 3-6
     every float matrix bucket, every projective bucket and every q
     bucket must have rows that the 16-byte batch kernels take (their C
     entries' rule on the padded length, the packed buffers being fresh,
     aligned allocations);
  5. graphics: one ``viewing_chain`` (camera, perspective, cull,
     viewport) projects a 2**20-point cloud in one launch, then 64 frames
     of 65536 points with the camera stepped around an orbit serve as one
     ``GeometryServer`` flush, one projective bucket;
  6. serve (q-mixed): the mixed serve's workload with every affine
     request submitted with ``qformat="q8.7"`` -- the odd ones (by index
     k among the affine requests) as int16 words, the even ones as
     float32, and every 16th (k = 0 mod 16) scaled by 512 so that it
     cannot fit and the default ``on_q_overflow="fallback"`` reroutes it
     to the float lane (47 a flush); projective requests go without a
     format.  Every q-lane result must be bitwise equal to the plain
     path on the card, to per-request ``apply(dtype="q8.7")`` and to the
     numpy Q oracle on the quantised points and fold, and a float
     submission's within ``quantize.error_bound`` of the float64 chain;
     int16 in gives int16 out, float in float32; each fallback bitwise
     equal to the float lane's ``apply``; the q buckets' launch bytes
     exactly half of what the same buckets move at 4 bytes a word.
  7. primitives: the paper's own routines -- translation and scaling at
     n = 8 and 64, the 8x8 matmul and Composite II on the port's M1
     emulator (host numpy), values equal to the int16 oracles, cycles
     beside the paper's Table 5 with the match flags the emulator's tests
     expect; then the eager primitives of ``core/transform_engine.py``
     (translate, scale, affine, rotate, vecadd) on a 2**20-point cloud
     (d = 2, and d = 3 for translate and scale), each bitwise equal to
     the same call with ``backend="ref"`` on the card and within its
     float64 bound; then the paper's comparison: kernel_bench.py's
     sequential pipeline translate(t2), scale(s), rotate(0.3),
     translate(t1) -- four launches, ``affine_2d`` x3 and ``matmul_2d``
     x1 -- against the same ``Transform2D`` chain's one
     ``chain_matrix_1d`` launch, with both results within 4 eps32 mag_c
     of the exact transform, mag_c = sum_m (|p_m| + |t2_m|) |s_m| |R_mc|
     + |t1_c| (so within 8 eps32 mag_c of each other), their opcount
     bytes and CUDA-event times of the calls as a user makes them (the
     kernels alone are summed from phase 8's rows at the cloud shape).
     In phases 3-7 kernel launch counts are zeroed just before each path
     and read just after.  Every served or projected float result must be
     bitwise equal to the same request run with ``backend="ref"`` (the
     plain PyTorch versions) on the card and to per-request
     ``apply``/``project``, masks included, and within the float64 bound
     of its fold: 4 eps32 (sum_m |p_m A_mc| + |t_c|) for affine plans,
     4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| +
     |H_dd|)] / |w| for projective ones, whose masks must equal the
     float64 mask wherever every margin exceeds that bound;
  8a. scene: ``repro_torch.scene`` on the serving path, the scene
     benchmark's two animated scenes (``tests/torch_scenes.py``) at 8
     branch roots of 64 leaves, 16 384 points a leaf, 30 frames: the
     diag scene in 2D, the matrix scene in 3D under a rotating camera;
     each frame re-poses one branch root and serves every leaf through
     ``submit_scene`` on q8.7 and float32 and through
     ``submit(world_chain)`` on float32, one flush (``scene_phase``:
     folds == dirtied every frame, results bitwise equal to their twins,
     to the same frame through the plain versions on the card
     (``backend="ref"``, the same buckets), to per-request ``apply`` and
     to the numpy Q oracle, the counters
     pinned, one ``submit_scene_async`` burst bitwise equal to the sync
     frame); serve ms a frame and fold counts printed;
  8. serve (hymba-1.5b): the model stack's serving path at full width
     (1.59 B parameters, bfloat16, random weights from seed 0): batch 4,
     2048-token prompts (numpy seed 0) and 16 generated tokens through
     ``launch.serve.serve_batch``, with prefill and per-token decode ms
     (CUDA events), tokens/s and peak memory; launch counts zeroed before
     the serve and read after the prefill and after the decode, each of
     ``rmsnorm_2d`` (5L+1 a pass), ``rope_3d`` (2L), ``flash_attention_3d``
     and ``ssd_intra`` (L, prefill only) and ``vecadd_2d`` (2L) held to
     its expected count; the serve runs as the compiled step
     (``Model.prefill`` and ``Model.decode`` captured as CUDA graphs and
     replayed), its first serve capturing and its second replaying only,
     both bitwise equal to an ``eager=True`` serve (tokens and every
     step's logits), with its launches, decode sizes equal at every
     position and no synchronising call in the replayed loop
     (``set_sync_debug_mode("error")``); eager, first and second
     serves' prefill and decode ms, capture ms, host µs a replay and
     peak memory printed; served twice, tokens and logits bitwise equal;
     then the same model on the plain versions
     (``dispatch.use_backend("ref")``) teacher-forced with the served
     tokens, every step's logits within ``logits_rtol`` (relative RMS)
     of the kernel path's, and every greedy token equal to the plain
     path's but at a near-tie (``model_phase``); the distinct sizes each
     kernel was launched with in the serve are kept for phase 9;
  8b. serve (granite-moe-3b-a800m): the same for the MoE family (3.37 B
     parameters, 40 experts top 8, attention only: ``rmsnorm_2d`` 2L+1,
     ``rope_3d`` 2L, ``flash_attention_3d`` L without a window, GQA
     group 3, ``vecadd_2d`` 2L a prefill), with the same gates;
  8c. serve (granite-moe-3b-a800m int8 KV cache): the same weights with
     ``kv_cache_dtype="int8"`` (a linear cache: no window), the same
     gates and launches; beside them, ungated, each decode step's logits
     against the same model with a bfloat16 cache teacher-forced with the
     same tokens (relative RMS beside ``int8_rms_bound``, sqrt(2L+1)
     2**-7 = 0.063) and both caches' bytes;
  8d. serve (whisper-medium): the enc-dec family at full width and depth
     (24 + 24 layers, 959.2 M parameters), batch 4, 1500 zero encoder
     frames (whisper's 30-second window) and the prompts' first token,
     16 tokens from position 1: ``rmsnorm_2d`` 2E+1+3L+1,
     ``flash_attention_3d`` E+2L (the encoder without a mask, the
     decoder's self- and cross-attention) and ``vecadd_2d`` 2E+3L a
     prefill, 3L+1, L (cross-attention) and 3L a decode step, no
     ``rope_3d``; the same gates, envelope 0.109;
  8e. serve (internvl2-76b): the VLM family at full width (d 8192, 64
     query and 8 kv heads of 128, d_ff 28672, vocab 128 256), its 80
     layers cut to 4 (5.52 B parameters; the full model's 141 GB wait
     for sharding), the hymba serve's batch and lengths, the first 256
     positions a zero patch prefix; launches as a dense layer's, the
     same gates, envelope 0.028;
  8f. train (hymba-1.5b): full width and depth (32 layers, 1.59 B
     parameters), bfloat16, remat "dots", ``SyntheticLMData`` (seed 0)
     at a global batch of 4 x 2048 tokens, 2 rows a micro-batch
     (accumulation over 2), ``AdamWConfig(total_steps=3,
     warmup_steps=1)``: step 1's loss, gradients (relative RMS, all
     flattened together) and global gradient norm on the kernel path
     within ``logits_rtol`` (0.109) of the same step under
     ``use_backend("ref")``, every gradient present and finite; step 1
     twice from the same state bit for bit; three steps of
     ``launch.train.train_loop`` through the compiled step (step 1
     eager, then one CUDA graph of the whole step replayed, no
     synchronising call in a replayed step's enqueue) and the same three
     with ``eager=True``, bit for bit at every step (loss, gradient norm,
     every parameter and optimizer leaf's digests), three finite losses;
     in every step each model kernel's launches (twice a pass's layers
     under "dots", whose backward recomputes each layer's kernels, plus
     the final norm) and plain backwards (``kernels.grad.backward_counts``,
     one a forward launch) exactly ``expected_train_launches``, replays
     included; both loops' ms a step, tokens/s and peak memory, the
     capture ms and host µs a replay, the eager loop's
     forward/backward/optimizer/plain-backward ms from CUDA events; the
     trained weights served after steps 2 and 3 of the compiled loop,
     the second serve without a capture, its tokens an ``eager=True``
     serve's, ``memory_allocated`` flat within 1 % (``train_phase``); it
     runs after the serves and before the chaos, async and autotune
     phases;
  8g. train on a 1x1 mesh (after 8f): 8f's ``train_loop`` on
     ``make_local_mesh()`` over a one-rank NCCL group, twice: 2 steps
     with ``eager=True`` (the functional mesh step, DTensor's dispatch op
     by op: the eager mesh baseline, its collectives counted), then 3
     steps through the compiled mesh step (``launch.mesh.compiled_route``:
     step 1 the in-place step eager over DTensor buffers, one CUDA graph
     captured, steps 2-3 replays with no synchronising call in their
     enqueue); every step's loss, gradient norm and parameter and
     optimizer leaf digests bit for bit 8f's at that step, its launches
     and plain backwards ``expected_train_launches``
     (``mesh_train_phase``);
  8h. serve on a 1x1 mesh (after 8b): granite's serve under
     ``mesh_context(make_local_mesh())``, eagerly (bit for bit the serve
     without a mesh, the MoE mesh path L x (1 + 16) times) and then
     compiled, a capturing and a replayed serve, each bit for bit the
     eager mesh serve with its launches (``mesh_serve_phase``);
  8i. serve on a 1x2 mesh (yi-6b): full width (32 layers, 6.06 B
     parameters, random weights from seed 0) on a ("data", "model") mesh
     of (1, 2), two processes sharing the card in one gloo group (NCCL
     refuses two ranks on one device; gloo's host collectives keep the
     serve on the eager route, which its line records and gates), the
     weights placed by
     ``params_specs``: each rank holds and runs 16 of the 32 query and 2
     of the 4 kv heads, 5 504 of the 11 008 hidden columns and 32 000 of
     the 64 000 vocabulary rows (``tp_serve_phase``); the hymba serve's
     batch, lengths and 16 tokens through ``serve_batch``; the logits and
     tokens against the same weights served without a mesh (rank 0,
     teacher-forced) under ``model_phase``'s rules (envelope 0.077), two
     mesh serves bitwise, each rank's launches exactly
     ``expected_launches`` and its collectives exactly
     ``tp_collectives`` (all-reduces only); then hymba-1.5b on the same
     mesh (full width, 1.59 B), whose 25/5 heads and 32 001-row
     vocabulary the axis does not divide (``sharding.attn_layout``):
     attention on the prompt's sequence split (1536-token prompts, 768
     positions a rank, ``flash_attention_3d`` with ``q_offset``), decode
     against the ring cache split by slots (the prefill fills both
     ranks' slots, the 4 decode steps write slots 512-515 of rank 1), the
     SSM decode split on its state's head dim, the head on split tokens,
     under the same gates (envelope 0.109), its all-reduces exactly
     ``tp_collectives`` and its gathers recorded (gloo's functional
     all-gather of CUDA tensors runs on host copies,
     ``GlooCudaCollectives``; yi's run issues none and runs without it);
     the kernels at the ranks' shapes are checked in phase 9;
  9. each kernel at the path's shapes (flat 2**24 points for d = 2 and 3,
     the flat kernels also at the median and the largest request of the
     served workload -- the sizes per-request ``apply``/``project`` hand
     them -- and the batch kernels at the largest served bucket of each
     plan kind, ``chain_diag_batch_2d`` and ``chain_matrix_batch_2d`` also
     at the largest d = 3 bucket and, untimed, through their scalar
     kernels: rows of no whole vector or group (39 floats; L odd, L = 6
     at d = 3), B > 1024, points one element off 16-byte alignment
     (``chain_matrix_batch_2d``'s 16-byte kernel also untimed at d = 3
     and B > 1024); ``chain_project_batch_2d`` also at the graphics
     bucket, (64, 65536, 3), and, untimed, through its 16-byte kernel at
     B > 1024 and its scalar kernel (L odd, L = 6, B > 1024, the largest
     and the graphics bucket off alignment); ``chain_project_1d``, whose
     request rows run its scalar kernel and whose 2**24 rows its 16-byte
     one, also untimed at N below 2**19, at points off 16-byte alignment
     and at 2**20 + 3, the 16-byte kernel's tail;
     ``chain_matrix_batch_2d_q`` and ``chain_diag_batch_2d_q``, whose
     served buckets run their 16-byte kernels, also untimed at d = 3 and
     B > 1024 and through their scalar kernels: rows of no multiple of 8
     words, B > 1024, the largest q bucket off 16-byte alignment, each
     also against the numpy Q oracle):
     bitwise equal to its plain version on the same inputs
     (points and mask; the int16 kernels at full-range words and at
     n_frac 0, 7 and 15), timed with CUDA events (median of 25 runs, L2
     flushed between runs and the device kept busy while the host
     enqueues, so the time is the device's) and its host cost per call,
     beside its plain version, one PyTorch library call
     (``torch.addcmul`` / ``torch.baddbmm``; for the projective and the
     int16 kernels, which no single call computes, a composite: for the
     projective ones ``addmm``/``baddbmm``, a divide and two compares,
     for the int16 ones a float64 ``addcmul``/``addmm``/``baddbmm``, then
     an int64 rounding shift) -- a yardstick only, the port never calls
     it -- and its bound, and for a row bound by bytes a device copy of
     as many bytes (``copy_ms``, the floor of one pass as timed here);
     the eager kernels at the shapes of
     kernel_bench.py and of the primitives phase: ``affine_2d`` and
     ``vecadd_2d`` at (1024, 1024) float32 and bfloat16 and at (2**20, 2),
     ``matmul_2d`` at 1024**3 bfloat16 and float32, at 4096**3 bfloat16
     and at (2**20, 2) @ (2, 2) -- bit for bit but for its tensor-core
     regime (bfloat16 with K > 8 or N > 8), held within
     ``bounds.matmul_bound`` -- against ``torch.addcmul`` / ``torch.add`` /
     ``torch.matmul`` (and checked, untimed, at (130, 1024, 70) bfloat16,
     the tensor-core regime's per-thread loads, and at the rotate shape
     in bfloat16; ``affine_2d`` bitwise in each of its regimes: flat
     vectors at N = 1, 2, 4, 8 with scalar tails, column vectors at N =
     8, 12, 1600 and 2**20, the scalar kernel at N = 3 and 100 and with
     x or s one element off 16-byte alignment),
     and ``chain_matrix_1d`` at (2**20, 2); then the paper's comparison
     of the kernels alone: three ``affine_2d`` and one ``matmul_2d`` row
     medians at the cloud shape, summed, against ``chain_matrix_1d``'s;
     the model kernels at every shape the hymba serve gives them
     (``rmsnorm_2d`` at (8192, 3200) and (4, 3200) float32, (4, 1600)
     and (8192, 1600) bfloat16; ``rope_3d`` at (20 | 100, 2048, 64) from
     position 0 and (20 | 100, 1, 64) at the last decode position,
     bfloat16, bit for bit, and, untimed, through its scalar kernel (D =
     20, x one element off 16-byte alignment); ``flash_attention_3d``
     checked at a 2000-token prompt with windows 1000 and 1024 and timed at 2048,
     window 1024, group 5; ``ssd_intra`` at 32 chunks of 256, 50 heads
     of 64, state 16 (the tensor-core kernel, within the bfloat16 branch
     of ``ssd_bounds``), also timed at mamba2-130m's prefill shape (24
     heads of 64, state 128) and checked, untimed, in float32 (the
     CUDA-core kernel); ``vecadd_2d`` at (8192, 1600) and (4, 1600)
     bfloat16, bit for bit; both kernels of ``rmsnorm.cu`` and of
     ``vecadd_2d``, the 16-byte one and the scalar one, checked untimed at
     a base one element off 16-byte alignment, at M = 1, ``rmsnorm_2d``
     at N = 33 and 100 and ``vecadd_2d`` at totals no multiple of 8),
     each within its ``tests/torch_bounds.py``
     bound of the plain version, against ``F.rms_norm``,
     ``scaled_dot_product_attention`` with the same mask, ``torch.add``
     or a composite (rotate-half RoPE; the bfloat16 masked-matmul SSD);
     the granite serve's shapes too (``rmsnorm_2d`` at (8192, 1536) and
     (4, 1536), ``rope_3d`` at (96 | 32, 2048 | 1, 64), flash at (96,
     32, 2048, 64) without a window and ``vecadd_2d`` at (8192, 1536)
     and (4, 1536), bfloat16; timed: the norm, q's RoPE, flash and the
     residual add at the prefill shape); whisper-medium's, all timed
     (``rmsnorm_2d`` and ``vecadd_2d`` at (6000, 1024) and (4, 1024),
     flash at (64, 64, 1500 | 1, 64) without a mask against 1500 keys
     and at (64, 64, 1, 64) causal against 1 key) and internvl2-76b's,
     all timed (``rmsnorm_2d`` and ``vecadd_2d`` at (8192, 8192) and (4,
     8192), ``rope_3d`` at (256 | 32, 2048 | 1, 128), flash at (256, 32,
     2048, 128), group 8); every size a kernel was launched with in any
     of the five serves must be among the sizes these checks launched it
     with;
 10. autotune (after every timed phase, before the chaos soak): (a)
     every candidate of every tunable kernel launched once at the served
     shapes -- the five single-chain kernels at 16 384 and 2**24 points,
     d = 2 and 3; the batch kernels at the largest affine, mixed and q
     buckets (PERF.md section 6 rows 2, 4, 6, 9, 10) and the graphics
     bucket, both candidate spaces (waves; threads x waves) --
     each output bitwise equal to the default config's; ``matmul_2d`` at
     1024**3 and 4096**3 bfloat16, every (bn, stages) within
     ``matmul_bound`` of the plain version and bitwise equal to the
     default at the default's BN (whether another BN is bitwise too is
     printed, not gated); ``rmsnorm_2d`` at (8192, 1600) bfloat16, every
     feasible ``row_warps`` within ``rmsnorm_bound``, the kernel's own
     count bitwise (another count sums the row in another order; printed,
     not gated); (b) the tuners at those shapes (every feasible kernel
     candidate timed: the model scores the chain candidates' tails alike)
     and the serving grid on the mixed workload, each decision's default
     ms, winner and winner ms printed, the winners saved to
     TUNED_CACHE_PATH; (c) the mixed workload served with tuning enabled
     and that cache installed, every result bitwise equal to the untuned
     serve's and to per-request ``apply``/``project`` under tuning, its
     launches, padded points and flush ms beside the default grid's, in
     turns (default, tuned, tuned, default), ungated; (d) tuning
     disabled, ``config_for`` gives ``DEFAULTS`` again; (e) with the
     traced flush below: ``obs.Profile`` folds its span stream,
     ``byte_ratio_exact`` and its launches equal to the server's;
 11. (run after phase 10, after every timed phase: the soak leaves the
     process's later flushes unpacking onto freshly faulted host pages)
     the serving layer's fault tolerance and async front end, each path
     with the launch counts zeroed just before it and read just after
     (phases 3-6 above must also show 0 for every recovery counter --
     ``launch_failures``, ``retries``, ``backend_fallbacks``,
     ``bisections``, ``failed_requests`` -- so the ladder never hides a
     kernel that fails on the card):
     chaos (soak) -- ``serving.run_chaos_soak(seed=11, n_requests=64)``
     on the card's two-rung ladder (the kernels, then the plain versions
     on the card), every resolved result bitwise equal to per-request
     ``apply``/``project``, its counters exactly the JAX package's
     two-rung ones (``tests/torch_chaos.py``);
     chaos (mixed) -- the mixed serve's 1024 requests served clean and
     under ``FaultInjector(seed=11)`` at the soak's rates (no backoff
     sleeps): nothing lost, each resolved result bitwise equal to the
     clean flush's (masks included), the failed tickets exactly the
     poison ones, both flush times printed;
     traced flush -- one mixed flush under an ``obs.Tracer`` beside an
     untraced one, the Chrome trace written to TRACE_PATH (git-ignored),
     its span stream folded by ``obs.Profile`` (phase 10 (e));
     async -- the mixed workload submitted under a frozen
     ``VirtualClock`` and drained, bitwise equal to one synchronous
     flush with equal launches and bytes; then the JAX package's
     Poisson soak (``tests/torch_chaos.py``'s copy of
     ``benchmarks/soak_bench.py``'s driver and settings: seed 17, four
     tenants, a pool of 384 mixed-lane requests, 20 000 arrivals at
     150 000/s, token buckets that must fire), its counters exactly the
     reference's, nothing lost, with its host seconds;
 12. the ``kernels`` line (launches from the mixed serve, for the int16
     kernels from the q-mixed serve, for the eager ones from the
     primitives phase, for the model kernels from the hymba serve;
     each kernel also carries its launches in the scene, granite (with
     both caches), whisper and internvl2 serves and the training, and
     the model kernels a
     ``granite`` row and ``whisper`` and ``internvl2`` rows by shape;
     the five model kernels also a ``train`` row (the training
     micro-batch's shape, its launches and plain backwards a step and the
     ms of its plain vjp, ``plain_backward_case``);
     ``vecadd_2d`` also carries its hymba prefill row, ``rope_3d`` its
     decode rows, ``ssd_intra`` its mamba2-130m row,
     ``chain_matrix_batch_2d`` its largest d = 3 bucket's row,
     ``chain_project_batch_2d`` its graphics bucket's row), then the
     device line last.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
#: the float bounds the checks hold the kernels to, shared with the tests
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch.nn.functional as F  # noqa: E402

from repro_torch import autotune, configs, graphics, obs, quantize, scene, serving  # noqa: E402
from repro_torch.autotune import cache as tcache  # noqa: E402
from repro_torch.autotune import costmodel, search  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import transform_chain as tc  # noqa: E402
from repro_torch.core import transform_engine as te  # noqa: E402
from repro_torch.core.morphosys import intel, programs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.distributed import compression, elastic, sharding  # noqa: E402
from repro_torch.distributed.steps import (make_train_step,  # noqa: E402
                                           value_and_grad)
from repro_torch.kernels import _build, dispatch, grad, opcount  # noqa: E402
from repro_torch.kernels import attention as attention_op  # noqa: E402
from repro_torch.kernels import matmul as matmul_op  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_op  # noqa: E402
from repro_torch.kernels import rope as rope_op  # noqa: E402
from repro_torch.kernels import ssd_intra as ssd_op  # noqa: E402
from repro_torch.kernels import vecadd as vecadd_op  # noqa: E402
from repro_torch.kernels.affine import affine as diag_k  # noqa: E402
from repro_torch.kernels.affine import ref as diag_ref  # noqa: E402
from repro_torch.kernels.fixedpoint import fixedpoint as q_k  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fixedpoint import ref as q_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul as matrix_k  # noqa: E402
from repro_torch.kernels.matmul import ref as matrix_ref  # noqa: E402
from repro_torch.kernels.projective import projective as proj_k  # noqa: E402
from repro_torch.kernels.projective import ref as proj_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rms_k  # noqa: E402
from repro_torch.kernels.rope import ref as rope_ref  # noqa: E402
from repro_torch.kernels.rope import rope as rope_k  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_k  # noqa: E402
from repro_torch.launch.serve import (release_graphs, serve_batch,  # noqa: E402
                                      serve_inputs)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import global_norm, leaves  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

import torch_bounds as bounds  # noqa: E402
import torch_chaos  # noqa: E402
import torch_scenes  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: int32 multiply-adds run on half as many lanes as float32 ones (64
#: INT32 against 128 FP32 lanes an SM, Hopper architecture white paper)
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
N_FLAT = 1 << 24
REPS = 25
#: GPU cycles (~1 ms) the device spins before each timed run, so the
#: host's cost of enqueueing the call stays out of the event window
SPIN_CYCLES = 2_000_000
EPS32 = float(np.finfo(np.float32).eps)
SEED = 0
#: the graphics phase: one cloud projected in one launch, then frames
#: of one orbiting camera served as one bucket
CLOUD_POINTS = 1 << 20
FRAMES, FRAME_POINTS = 64, 65536
Q8_7 = quantize.Q8_7
#: the q-mixed serve: every FALLBACK_EVERY-th affine request is scaled
#: by FALLBACK_SCALE, out of q8.7's range
FALLBACK_EVERY, FALLBACK_SCALE = 16, np.float32(512.0)
#: the fraction-bit counts the int16 kernels are checked at
Q_FRACS = (0, 7, 15)
#: H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
#: the primitives phase: kernel_bench.py's sequential pipeline
#: translate(T2), scale(SV), rotate(THETA), translate(T1)
T1, T2, SV, THETA = (3.0, 2.0), (-1.0, 5.0), (1.3, 0.8), 0.3
#: Table 5's M1 rows the emulator reproduces exactly; the two matrix
#: routines have no published listing and the reconstruction is faster
EMULATOR_EXACT = {("translation", 8), ("translation", 64),
                  ("scaling", 8), ("scaling", 64)}
#: the model serve phases: full width, batch 4, 16 generated tokens;
#: hymba-1.5b, granite-moe-3b-a800m (also with an int8 KV cache) and
#: internvl2-76b on 2048-token prompts, whisper-medium on WHISPER_FRAMES
#: encoder frames
HYMBA_ARCH, GRANITE_ARCH = "hymba-1.5b", "granite-moe-3b-a800m"
WHISPER_ARCH, VLM_ARCH = "whisper-medium", "internvl2-76b"
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 4, 2048, 16
#: whisper's 30-second window after its stride-2 conv (arXiv:2212.04356
#: section 2.2): the encoder's length and the cross-attention's keys
WHISPER_FRAMES = 1500
#: internvl2-76b's depth on one card: its 80 layers are 141 GB in
#: bfloat16, more than one card holds; 4 layers at full width are 11 GB
VLM_LAYERS = 4
#: the train phase: hymba-1.5b at full width and depth, SyntheticLMData
#: (seed 0) at a global batch of 4 x 2048 tokens (the hymba serve's
#: lengths), 2 rows a micro-batch (accumulation over 2), three steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 3
#: rounding sites a layer where the kernel path's bfloat16 output may
#: land one ulp (2**-8 to 2**-7 relative) from the plain path's: a hybrid
#: layer's five rmsnorm_2d outputs and its flash_attention_3d output (the
#: tensor-core flash kernel also rounds P to bfloat16, within 2**-9
#: max|v| of its output); a dense, MoE or VLM layer's two rmsnorm_2d
#: outputs and its flash output; an enc-dec decoder layer's three norms
#: and two flash outputs (self and cross), an encoder layer's two norms
#: and one flash output (ENCODER_SITES).  rope_3d and vecadd_2d are
#: bitwise, SSD float32.
MODEL_SITES = {"hybrid": 6, "dense": 3, "moe": 3, "vlm": 3, "encdec": 5}
ENCODER_SITES = 3


def logits_rtol(cfg) -> float:
    """The kernel path's logits against the plain path's, relative RMS,
    a step -- an envelope, not the correctness check (phase 9 holds each
    kernel to its per-element bound at every shape of the path): each of
    the MODEL_SITES a layer over L layers, ENCODER_SITES over E encoder
    layers, and the final norms (the encoder's too), a full ulp at the
    top of the range, added in quadrature: sqrt(sites * L + 3 E + norms)
    * 2**-7 (hymba-1.5b 0.109, granite-moe-3b-a800m 0.077, whisper-medium
    sqrt(194) 2**-7 = 0.109, internvl2-76b at 4 layers 0.028; PERF.md)."""
    sites = (MODEL_SITES[cfg.family] * cfg.n_layers
             + ENCODER_SITES * cfg.encoder_layers + 1 + cfg.is_encdec)
    return math.sqrt(sites) * 2.0 ** -7


def int8_rms_bound(cfg) -> float:
    """The int8 KV cache's decode logits against the bfloat16 cache's,
    relative RMS, teacher-forced with the same tokens: an int8 step of
    max|row| / 254 is about one bfloat16 ulp at the top of the range,
    over K and V in each of L layers and the final norm, added in
    quadrature: sqrt(2 L + 1) * 2**-7 (granite-moe-3b-a800m 0.063).  A
    figure to record as met or missed, not a gate: the quantization is a
    designed loss (the JAX package holds it to atol 0.15)."""
    return math.sqrt(2 * cfg.n_layers + 1) * 2.0 ** -7


#: the recovery counters a clean serve must leave at 0: the ladder must
#: never hide a kernel that fails on the card
RECOVERY_KEYS = ("launch_failures", "retries", "backend_fallbacks",
                 "bisections", "failed_requests")
#: the chaos soak's injection rates (``run_chaos_soak``'s defaults),
#: which the chaos (mixed) phase serves the mixed workload under
CHAOS_RATES = dict(flaky_rate=0.06, backend_rate=0.05, corrupt_rate=0.05,
                   poison_rate=0.03)
#: the Chrome trace of one traced mixed flush, in the git-ignored
#: directory whose files a remote run brings back
TRACE_PATH = os.path.join(ROOT, "chiprun_out",
                          "chip_smoke_mixed_trace.json")
#: the winners of the autotune phase's search, in the git-ignored
#: directory whose files a remote run brings back
TUNED_CACHE_PATH = os.path.join(ROOT, "chiprun_out",
                                "chip_smoke_tuned_cache.json")
#: the autotune phase's shapes: the single-chain kernels at the served
#: median request and the flat rows' 2**24 points; matmul_2d at the
#: kernel_bench and the 4096**3 rows; rmsnorm_2d at hymba's prefill norm
TUNE_FLAT_POINTS = (16384, N_FLAT)
TUNE_MATMULS = ((1024, 1024, 1024), (4096, 4096, 4096))
TUNE_RMSNORM = (8192, 1600)
#: the kernel tuners' best-of count (CUDA-event windows a candidate)
TUNE_ITERS = 10
#: phase 8i: yi-6b, whose 32/4 heads, d_ff 11 008 and vocabulary 64 000 a
#: 2-wide ``model`` axis divides (every split of the Megatron layout), on
#: a (1, 2) mesh of two processes sharing the card over gloo (NCCL
#: refuses two ranks on one device); the ranks' group timeout, seconds
TP_ARCH, TP_MESH, TP_TIMEOUT = "yi-6b", (1, 2), 600
#: phase 8i's second run: hymba-1.5b, whose 25/5 heads and vocabulary of
#: 32 001 a 2-wide ``model`` axis does not divide -- attention on the
#: sequence split (``sharding.attn_layout``), decode against the cache
#: split by slots, the SSM decode split on its state's head dim, the head
#: on split tokens -- on the same mesh, generating 4 tokens (a decode
#: step's all-gathers through host copies and its 160 all-reduces over
#: gloo take ~1.7 s on that transport); 1536-token prompts: the prefill's ring keeps positions 512-1535, slots
#: on both ranks, and the decode's positions 1536-1539 take slots 512-515
#: of the 1024, which rank 1 owns
TP_HYBRID_ARCH, TP_HYBRID_PROMPT, TP_HYBRID_GEN = "hymba-1.5b", 1536, 4
#: the functional collectives that gloo runs wrong on CUDA tensors in the
#: card's PyTorch build, by op name (``tools/torch_gloo_probe.py`` on the
#: card, PERF.md): phase 8i's transport moves these to host copies
GLOO_CUDA_HOST_OPS = ("all_gather_into_tensor",)
#: each phase 8i rank's progress (and, if it hangs, its threads' stacks)
TP_LOG = os.path.join(ROOT, "chiprun_out",
                      "chip_smoke_tp_{arch}_rank{rank}.log")
#: the kernels the hybrid serving path launches
MODEL_PATH_KERNELS = ["rmsnorm_2d", "rope_3d", "flash_attention_3d",
                      "ssd_intra", "vecadd_2d"]

KERNELS = {   # name -> (source, the TPU kernel it replaces, plan kind)
    "chain_diag_1d": ("src/repro_torch/kernels/csrc/chain_diag.cu",
                      "src/repro/kernels/affine/affine.py:82", "diag"),
    "chain_diag_batch_2d": ("src/repro_torch/kernels/csrc/chain_diag.cu",
                            "src/repro/kernels/affine/affine.py:129", "diag"),
    "chain_matrix_1d": ("src/repro_torch/kernels/csrc/chain_matrix.cu",
                        "src/repro/kernels/matmul/matmul.py:99", "matrix"),
    "chain_matrix_batch_2d": ("src/repro_torch/kernels/csrc/chain_matrix.cu",
                              "src/repro/kernels/matmul/matmul.py:158",
                              "matrix"),
    "chain_project_1d": ("src/repro_torch/kernels/csrc/chain_project.cu",
                         "src/repro/kernels/projective/projective.py:82",
                         "projective"),
    "chain_project_batch_2d": ("src/repro_torch/kernels/csrc/chain_project.cu",
                               "src/repro/kernels/projective/projective.py:152",
                               "projective"),
    "chain_diag_1d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                        "src/repro/kernels/fixedpoint/fixedpoint.py:52",
                        "diag"),
    "chain_matrix_1d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                          "src/repro/kernels/fixedpoint/fixedpoint.py:97",
                          "matrix"),
    "chain_diag_batch_2d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                              "src/repro/kernels/fixedpoint/fixedpoint.py:140",
                              "diag"),
    "chain_matrix_batch_2d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                                "src/repro/kernels/fixedpoint/fixedpoint.py:183",
                                "matrix"),
    "affine_2d": ("src/repro_torch/kernels/csrc/affine_2d.cu",
                  "src/repro/kernels/affine/affine.py:52", "eager"),
    "vecadd_2d": ("src/repro_torch/kernels/csrc/affine_2d.cu",
                  "src/repro/kernels/affine/affine.py:165", "eager"),
    "matmul_2d": ("src/repro_torch/kernels/csrc/matmul_2d.cu",
                  "src/repro/kernels/matmul/matmul.py:40", "eager"),
    "rmsnorm_2d": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "src/repro/kernels/rmsnorm/rmsnorm.py:33", "model"),
    "rope_3d": ("src/repro_torch/kernels/csrc/rope.cu",
                "src/repro/kernels/rope/rope.py:38", "model"),
    "flash_attention_3d": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:92", "model"),
    "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_intra.cu",
                  "src/repro/kernels/ssd/ssd.py:59", "model"),
}
FLAT = {"diag": "chain_diag_1d", "matrix": "chain_matrix_1d",
        "projective": "chain_project_1d"}
BATCH = {"diag": "chain_diag_batch_2d", "matrix": "chain_matrix_batch_2d",
         "projective": "chain_project_batch_2d"}
Q_FLAT = {"diag": "chain_diag_1d_q", "matrix": "chain_matrix_1d_q"}
Q_BATCH = {"diag": "chain_diag_batch_2d_q", "matrix": "chain_matrix_batch_2d_q"}
FLOAT_KERNELS = [k for k, v in KERNELS.items()
                 if v[2] not in ("eager", "model") and not k.endswith("_q")]
EAGER_KERNELS = [k for k, v in KERNELS.items() if v[2] == "eager"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


#: the 16-byte global loads and stores of the memory-bound kernels
VEC_OPS = ("LDG.E.128", "STG.E.128")
#: the instructions each redesigned kernel's SASS must hold, by source and
#: kernel: every ``Function :`` section of the kernel's name (each template
#: instance) must hold each instruction; None stands for the whole
#: library.  wgmma and TMA loads for the tensor-core kernels, 128-bit
#: global loads and stores for the 16-byte-access ones
SASS_REQUIRED = {"matmul_2d": {None: ("HGMMA", "UTMALDG")},
                 "flash_attention": {None: ("HGMMA", "UTMALDG")},
                 "rmsnorm": {"rmsnorm_vec_kernel": VEC_OPS},
                 "affine_2d": {"vecadd_vec_kernel": VEC_OPS,
                               "affine_flat_kernel": VEC_OPS,
                               "affine_col_kernel": VEC_OPS},
                 "chain_diag": {"chain_diag_vec_kernel": VEC_OPS},
                 "ssd_intra": {None: ("HGMMA", "UTMALDG")},
                 "chain_project": {"chain_project_vec_kernel": VEC_OPS,
                                   "chain_project_batch_vec_kernel": VEC_OPS},
                 "rope": {"rope_vec_kernel": VEC_OPS},
                 "chain_fixedpoint": {
                     "chain_matrix_batch_q_vec_kernel": VEC_OPS,
                     "chain_diag_batch_q_vec_kernel": VEC_OPS},
                 "chain_matrix": {"chain_matrix_batch_vec_kernel": VEC_OPS}}


def sass_sections(source: str) -> dict:
    """The SASS of the built library of ``csrc/<source>.cu`` by
    ``cuobjdump -sass``: {mangled function name: its instructions}."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build_all()[source])],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def sass_counts(source: str) -> dict:
    """{kernel: {function: {instruction: count}}} for the kernels of
    ``SASS_REQUIRED[source]`` ("library" for None; ``LDG.E.128`` also
    counts its suffixed forms, such as ``LDG.E.128.CONSTANT``)."""
    sections = sass_sections(source)
    counts = {}
    for kernel, ops in SASS_REQUIRED[source].items():
        found = {"library": "".join(sections.values())} if kernel is None \
            else {f: body for f, body in sections.items() if kernel in f}
        counts[kernel or "library"] = {
            f: {op: body.count(op) for op in ops} for f, body in found.items()}
    return counts


def sass_missing(counts: dict) -> list:
    """The kernels of ``sass_counts`` with no section, or with a section
    that lacks one of its instructions."""
    return [k for k, fns in counts.items()
            if not fns or not all(all(c.values()) for c in fns.values())]


def off_vector_buckets(reports, q_reports=()) -> list:
    """The served buckets whose rows a 16-byte batch kernel does not take,
    by its C entry's rule on the padded length
    (``costmodel.batch_takes_vectors``; the packed buffers are fresh
    device allocations, so 16-byte aligned): the float matrix and
    projective buckets, and the q ones of ``q_reports``."""
    q_ids = {id(r) for r in q_reports}
    bad = []
    for rep in reports:
        d = int(rep.structure[0])
        q = id(rep) in q_ids
        if rep.kind == "diag" and not q:
            continue
        kind = rep.kind + ("_q" if q else "")
        if not costmodel.batch_takes_vectors(kind, rep.lpad, d):
            bad.append((rep.kind, rep.requests, rep.lpad, d))
    return bad


def require_launched(counts: dict, names, phase: str) -> None:
    for name in names:
        if counts[name] == 0:
            raise SystemExit(f"{name} was never launched in the {phase} run")


def require_clean(stats, phase: str) -> None:
    """A serve without injected faults ran no step of the recovery
    ladder: every launch succeeded on the kernel it was planned for."""
    dirty = {k: stats[k] for k in RECOVERY_KEYS if stats[k]}
    if dirty:
        raise SystemExit(f"{phase}: the recovery ladder ran in a clean "
                         f"serve: {dirty}")


# -- the float64 oracles ---------------------------------------------------------

def fold_oracle_ok(chain, pts: np.ndarray, out: np.ndarray) -> bool:
    """``out`` within 4 float32 epsilons per term of the float64 value of
    the chain's float32 fold: |out - q| <= 4 eps (sum_m |p_m A_mc| + |t_c|)."""
    p = pts.reshape(-1, chain.dim).astype(np.float64)
    if chain.is_diagonal:
        s, t = (f.astype(np.float64) for f in chain.fold())
        q, mag = p * s + t, np.abs(p * s) + np.abs(t)
    else:
        a, t = (f.astype(np.float64) for f in chain.fold())
        q, mag = p @ a + t, np.abs(p) @ np.abs(a) + np.abs(t)
    got = out.reshape(-1, chain.dim).astype(np.float64)
    return bool(np.isfinite(got).all()
                and (np.abs(got - q) <= 4 * EPS32 * mag).all())


def project_oracle_ok(folded, pts: np.ndarray, out: np.ndarray,
                      mask: np.ndarray) -> tuple[bool, int]:
    """A projective result against the float64 value of its float32 fold
    (H, lo, hi): every element within

        4 eps [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

    (4 eps (sum_m |p_m H_mc| + |H_dc|) where w <= 0) wherever w's margin
    to 0 exceeds its own bound, and the mask equal to the float64 mask
    wherever every margin exceeds the bound.  Returns (ok, points whose
    margins lie within the bound -- not held to the float64 mask)."""
    d = pts.shape[-1]
    p = pts.reshape(-1, d).astype(np.float64)
    h, lo, hi = (f.astype(np.float64) for f in folded)
    qh = p @ h[:d] + h[d]
    mag = np.abs(p) @ np.abs(h[:d]) + np.abs(h[d])
    w = qh[:, d]
    w_ok = w > 0
    safe = np.where(w_ok, w, 1.0)[:, None]
    v = qh[:, :d] / safe
    bound = 4 * EPS32 * np.where(w_ok[:, None],
                                 (mag[:, :d] + np.abs(v) * mag[:, d:]) / safe,
                                 mag[:, :d])
    w_clear = np.abs(w) > 4 * EPS32 * mag[:, d]
    got = out.reshape(-1, d).astype(np.float64)
    values_ok = np.isfinite(got).all() \
        and bool((np.abs(got - v) <= bound)[w_clear].all())
    inside64 = w_ok & np.all((v >= lo) & (v <= hi), axis=-1)
    clear = w_clear & np.all((np.abs(v - lo) > bound)
                             & (np.abs(v - hi) > bound), axis=-1)
    mask_ok = bool((mask.reshape(-1) == inside64)[clear].all())
    return values_ok and mask_ok, int((~clear).sum())


def check_result(i, chain, pts, out, ref, per_request, per_request_mask):
    """Hold one served result to the plain path's, to per-request
    ``apply``/``project`` and to the float64 oracle; returns the points
    left out of the mask comparison."""
    if out.shape != pts.shape or not np.isfinite(out).all():
        raise SystemExit(f"request {i}: bad result shape/values")
    if not bitwise_equal(out, ref):
        raise SystemExit(f"request {i}: kernel != plain version on the card")
    if not bitwise_equal(out, per_request):
        raise SystemExit(f"request {i}: packed != per-request apply/project")
    if not chain.is_projective:
        if not fold_oracle_ok(chain, pts, out):
            raise SystemExit(f"request {i}: outside 4 eps of the float64 fold")
        return 0
    for other in (ref.mask, per_request_mask):
        if not bitwise_equal(out.mask, other):
            raise SystemExit(f"request {i}: mask != plain/per-request mask")
    ok, undecided = project_oracle_ok(chain.fold(), pts, out, out.mask)
    if not ok:
        raise SystemExit(f"request {i}: outside the float64 projective bound")
    return undecided


# -- the serving paths -------------------------------------------------------------

def serve_phase(phase: str, templates, device: str = "cuda",
                n_requests: int = 1024, min_points: int = 1024,
                max_points: int = 262144) -> tuple[dict, dict, dict, dict]:
    """Drive one serving path; returns (kernel launch counts of the run,
    the serving summary, the largest served bucket shape per plan kind,
    the median and the largest request's point count per plan kind)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=n_requests, templates=templates,
        min_points=min_points, max_points=max_points)
    n_kind = {k: sum(c.plan_kind == k for c, _ in reqs) for k in FLAT}

    serving.reset_stats()
    _build.reset_launch_counts()
    srv = serving.GeometryServer(device=device)
    outs, submit_s, flush_s, timings, _ = timed_serve(
        srv, [(c, p, None) for c, p in reqs])
    t0 = time.perf_counter()
    singles = []
    for c, p in reqs:
        x = torch.from_numpy(p).to(device)
        if c.is_projective:
            q, m = c.project(x)
            singles.append((q.cpu().numpy(), m.cpu().numpy()))
        else:
            singles.append((c.apply(x).cpu().numpy(), None))
    apply_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    flushes = 4
    require_clean(stats, phase)

    buckets = len(srv.last_report)
    if stats["launches"] != stats["buckets"] or stats["buckets"] != flushes * buckets:
        raise SystemExit(f"launches {stats['launches']} != buckets "
                         f"{stats['buckets']} ({flushes} x {buckets})")
    batched = sum(counts[name] for name in BATCH.values())
    if batched != stats["launches"]:
        raise SystemExit(f"batch kernels launched {batched} times, serving "
                         f"counted {stats['launches']} launches")
    for kind, name in FLAT.items():
        if counts[name] != n_kind[kind]:
            raise SystemExit(f"per-request calls launched {name} "
                             f"{counts[name]} times for {n_kind[kind]} "
                             f"{kind} requests")
    used = [k for k in FLAT if n_kind[k]]
    require_launched(counts, [FLAT[k] for k in used]
                     + [BATCH[k] for k in used], phase)
    off = off_vector_buckets(srv.last_report)
    if off:
        raise SystemExit(f"{phase}: buckets {off} run a scalar batch kernel")

    ref_outs = serving.GeometryServer(device=device, backend="ref").serve(reqs)
    undecided = 0
    for i, ((chain, pts), out) in enumerate(zip(reqs, outs)):
        undecided += check_result(i, chain, pts, out, ref_outs[i],
                                  *singles[i])

    summary = {
        "phase": phase, "requests": len(reqs), "requests_by_kind": n_kind,
        "buckets": buckets,
        **flush_summary(stats, flushes, submit_s, flush_s, timings),
        "payload_MB": sum(p.nbytes for _, p in reqs) / 1e6,
        "per_request_ms": apply_s * 1e3,
        "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
        "fold_oracle": True, "mask_points_within_bound": undecided,
    }
    largest = largest_buckets(srv.last_report)
    sizes = {}
    for kind in used:
        n = sorted(p.shape[0] for c, p in reqs if c.plan_kind == kind)
        sizes[kind] = (n[len(n) // 2], n[-1])
    sizes["all"] = (sorted(p.shape[0] for _, p in reqs)[len(reqs) // 2],
                    max(p.shape[0] for _, p in reqs))
    return counts, summary, largest, sizes


def timed_serve(srv, subs) -> tuple:
    """One warm flush of the (chain, points, qformat) submissions, then
    three rounds of submitting them all and one flush, submit and flush
    timed apart.  Returns (the last flush's results, submit seconds,
    flush seconds, the server's phase timings, the last flush's opcount
    records)."""
    submit_s, flush_s, timings, outs, records = [], [], [], None, None
    for k in range(4):
        t0 = time.perf_counter()
        for chain, pts, q in subs:
            srv.submit(chain, pts, qformat=q)
        t1 = time.perf_counter()
        with opcount.counting() as records:
            outs = srv.flush()                       # numpy results: synced
        if k:                                        # the first one warms
            flush_s.append(time.perf_counter() - t1)
            submit_s.append(t1 - t0)
            timings.append(srv.last_timing)
    return outs, submit_s, flush_s, timings, records


def flush_summary(stats, flushes, submit_s, flush_s, timings) -> dict:
    """The per-flush counters and the host and device times of a serve."""
    med = {k: float(np.median([t[k] for t in timings])) for k in timings[0]}
    return {
        "launches_per_flush": stats["launches"] // flushes,
        "payload_points": stats["payload_points"] // flushes,
        "padded_points": stats["padded_points"] // flushes,
        "submit_ms": [s * 1e3 for s in submit_s],
        "flush_ms": [s * 1e3 for s in flush_s],
        "flush_ms_median": float(np.median(flush_s)) * 1e3,
        "points_per_s": stats["payload_points"] // flushes
        / float(np.median(flush_s)),
        "served_points_per_s": stats["payload_points"] // flushes
        / float(np.median(np.add(submit_s, flush_s))),
        "pack_ms": med["pack_s"] * 1e3, "dispatch_ms": med["dispatch_s"] * 1e3,
        "unpack_ms": med["unpack_s"] * 1e3,
        "device_span_ms": med.get("device_ms"),
    }


def largest_buckets(reports) -> dict:
    """The (requests, lpad, d) of the largest bucket of each plan kind,
    under the key ``kind`` and, for each d, under ``(kind, d)``."""
    largest = {}
    for rep in reports:
        d = int(rep.structure[0])
        for key in (rep.kind, (rep.kind, d)):
            if rep.padded_points > largest.get(key, (0, 0, 0, 0))[3]:
                largest[key] = (rep.requests, rep.lpad, d, rep.padded_points)
    return {k: v[:3] for k, v in largest.items()}


def q_submissions(reqs) -> list:
    """(chain, submitted points, qformat) for the q-mixed serve: affine
    request k (in submission order) goes with q8.7, as int16 words when k
    is odd and as float32 when it is even, scaled out of range when
    k = 0 mod FALLBACK_EVERY; projective requests go without a format."""
    subs, k = [], 0
    for chain, pts in reqs:
        if chain.is_projective:
            subs.append((chain, pts, None))
            continue
        if k % 2:
            pts = Q8_7.quantize(pts)
        elif k % FALLBACK_EVERY == 0:
            pts = pts * FALLBACK_SCALE
        subs.append((chain, pts, Q8_7.name))
        k += 1
    return subs


def q_oracle(chain, pts: np.ndarray) -> np.ndarray:
    """The numpy Q oracle's result for one q-lane request: the points
    quantised (int16 words pass as they are), the fold quantised by
    ``quantize_fold``, dequantised back for a float submission."""
    words = pts if pts.dtype == np.int16 else Q8_7.quantize(pts)
    folded_q = quantize.quantize_fold(chain.fold(), chain.plan_kind, Q8_7)
    oracle = q_ref.np_chain_diag_q if chain.is_diagonal \
        else q_ref.np_chain_matrix_q
    out = oracle(words.reshape(-1, chain.dim), *folded_q, Q8_7.n)
    out = out.reshape(pts.shape)
    return out if pts.dtype == np.int16 else Q8_7.dequantize(out)


def q_bound_ok(chain, pts: np.ndarray, out: np.ndarray) -> bool:
    """A float submission's q result within ``quantize.error_bound`` of
    the float64 value of the chain's float32 fold."""
    folded = chain.fold()
    p = pts.reshape(-1, chain.dim).astype(np.float64)
    f64 = [f.astype(np.float64) for f in folded]
    exact = p * f64[0] + f64[1] if chain.is_diagonal else p @ f64[0] + f64[1]
    bound = quantize.error_bound(folded, chain.plan_kind, Q8_7,
                                 float(np.abs(pts).max()))
    got = out.reshape(-1, chain.dim).astype(np.float64)
    return bool((np.abs(got - exact) <= bound).all())


def q_mixed_phase(device: str = "cuda") -> tuple[dict, dict, dict, tuple]:
    """The q-mixed serve (see the module docstring); returns (kernel launch
    counts of the run, the summary, the largest q bucket shape per plan
    kind, the median and the largest q-lane request's point count)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=1024, templates=workload.TEMPLATES,
        min_points=1024, max_points=262144)
    subs = q_submissions(reqs)
    affine = [i for i, (_, _, q) in enumerate(subs) if q]
    fallback = set(affine[::FALLBACK_EVERY])
    q_lane = [i for i in affine if i not in fallback]

    serving.reset_stats()
    _build.reset_launch_counts()
    srv = serving.GeometryServer(device=device)
    outs, submit_s, flush_s, timings, records = timed_serve(srv, subs)
    t0 = time.perf_counter()
    singles = []
    for i, (c, p, q) in enumerate(subs):
        x = torch.from_numpy(p).to(device)
        if c.is_projective:
            out, mask = c.project(x)
            singles.append((out.cpu().numpy(), mask.cpu().numpy()))
        else:
            out = c.apply(x, dtype=None if i in fallback else q)
            singles.append((out.cpu().numpy(), None))
    apply_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    flushes = 4
    require_clean(stats, "serve (q-mixed)")

    buckets = len(srv.last_report)
    q_reports = [rep for (op, _), rep in zip(records, srv.last_report)
                 if op.endswith("_q")]
    if len(records) != buckets or stats["launches"] != stats["buckets"] \
            or stats["buckets"] != flushes * buckets:
        raise SystemExit(f"q-mixed: launches {stats['launches']} != buckets "
                         f"{stats['buckets']} ({flushes} x {buckets})")
    batched = sum(counts[name] for name in [*BATCH.values(),
                                            *Q_BATCH.values()])
    q_batched = sum(counts[name] for name in Q_BATCH.values())
    if batched != stats["launches"] or q_batched != flushes * len(q_reports):
        raise SystemExit(f"q-mixed: batch kernels launched {batched} times "
                         f"({q_batched} q) for {stats['launches']} launches "
                         f"({flushes} x {len(q_reports)} q buckets)")
    n_fallback = sum(rep.q_fallback_requests for rep in srv.last_report)
    if stats["q_fallbacks"] != flushes * len(fallback) \
            or n_fallback != len(fallback):
        raise SystemExit(f"q-mixed: {stats['q_fallbacks']} q fallbacks over "
                         f"{flushes} flushes, {n_fallback} in the last, "
                         f"expected {len(fallback)} a flush")
    for kind in ("diag", "matrix"):
        n_q = sum(subs[i][0].plan_kind == kind for i in q_lane)
        if counts[Q_FLAT[kind]] != n_q:
            raise SystemExit(f"q-mixed: {Q_FLAT[kind]} launched "
                             f"{counts[Q_FLAT[kind]]} times for {n_q} "
                             f"per-request {kind} q calls")
    require_launched(counts, [*Q_FLAT.values(), *Q_BATCH.values()],
                     "q-mixed serve")
    off = off_vector_buckets(srv.last_report, q_reports)
    if off:
        raise SystemExit(f"q-mixed: buckets {off} run a scalar batch kernel")
    for (op, nbytes), rep in zip(records, srv.last_report):
        if op.endswith("_q") and 2 * nbytes != opcount.packed_chain_bytes(
                rep.requests, rep.lpad, int(rep.structure[0]), itemsize=4,
                kind=rep.kind):
            raise SystemExit(f"q-mixed: {op} recorded {nbytes} bytes, not "
                             "half the float32 bytes of its bucket")

    ref_srv = serving.GeometryServer(device=device, backend="ref")
    for c, p, q in subs:
        ref_srv.submit(c, p, qformat=q)
    ref_outs = ref_srv.flush()
    undecided, int16_in = 0, 0
    for i, ((chain, pts, q), out) in enumerate(zip(subs, outs)):
        if i not in q_lane:          # projective, or rerouted to float32
            if i in fallback and out.dtype != np.float32:
                raise SystemExit(f"q-mixed request {i}: fallback not float32")
            undecided += check_result(i, chain, pts, out, ref_outs[i],
                                      *singles[i])
            continue
        want_dtype = np.int16 if pts.dtype == np.int16 else np.float32
        int16_in += pts.dtype == np.int16
        if out.dtype != want_dtype or out.shape != pts.shape:
            raise SystemExit(f"q-mixed request {i}: {pts.dtype} in, "
                             f"{out.dtype} {out.shape} out")
        for other, what in ((ref_outs[i], "the plain version on the card"),
                            (singles[i][0], "per-request apply(dtype=)"),
                            (q_oracle(chain, pts), "the numpy Q oracle")):
            if not bitwise_equal(out, other):
                raise SystemExit(f"q-mixed request {i}: != {what}")
        if want_dtype == np.float32 and not q_bound_ok(chain, pts, out):
            raise SystemExit(f"q-mixed request {i}: outside error_bound")

    summary = {
        "phase": "serve (q-mixed)", "requests": len(subs),
        "q_requests": len(affine), "q_lane": len(q_lane),
        "int16_submissions": int16_in,
        "float_submissions": len(q_lane) - int16_in,
        "q_fallbacks_per_flush": stats["q_fallbacks"] // flushes,
        "buckets": buckets, "q_buckets": len(q_reports),
        **flush_summary(stats, flushes, submit_s, flush_s, timings),
        "q_bucket_bytes": sum(b for op, b in records if op.endswith("_q")),
        "per_request_ms": apply_s * 1e3,
        "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
        "bitwise_vs_q_oracle": True, "error_bound": True,
        "q_bytes_half_of_float32": True,
        "mask_points_within_bound": undecided,
    }
    n = sorted(subs[i][1].shape[0] for i in q_lane)
    return counts, summary, largest_buckets(q_reports), \
        (n[len(n) // 2], n[-1])


def orbit_camera(k: int) -> graphics.Camera:
    """Frame k of the orbit: the camera of (3, 2, 6) stepped 2 pi k /
    FRAMES around the y axis, looking at the origin."""
    radius, angle = math.hypot(3.0, 6.0), math.atan2(6.0, 3.0)
    a = angle + 2 * math.pi * k / FRAMES
    return graphics.Camera(eye=(radius * math.cos(a), 2.0,
                                radius * math.sin(a)),
                           target=(0.0, 0.0, 0.0), fov_y=math.pi / 3,
                           aspect=16 / 9, near=0.5, far=50.0)


def graphics_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The graphics front door: one viewing chain projects a 2**20-point
    cloud (one ``chain_project_1d`` launch), then FRAMES frames of one
    orbiting camera serve as one flush (one ``chain_project_batch_2d``
    launch).  Returns (launch counts of the run, the summary)."""
    viewport = graphics.Viewport(0, 0, 1920, 1080, (0, 1))
    chain = graphics.viewing_chain(camera=orbit_camera(0), viewport=viewport)
    rng = np.random.default_rng(SEED)
    cloud = (rng.standard_normal((CLOUD_POINTS, 3)) * 4).astype(np.float32)
    frames = [(graphics.viewing_chain(camera=orbit_camera(k),
                                      viewport=viewport),
               (rng.standard_normal((FRAME_POINTS, 3)) * 4)
               .astype(np.float32)) for k in range(FRAMES)]
    cloud_dev = torch.from_numpy(cloud).to(device)
    torch.cuda.synchronize()

    serving.reset_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out, mask = chain.project(cloud_dev)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t0
    srv = serving.GeometryServer(device=device)
    t0 = time.perf_counter()
    served = srv.serve(frames)                       # submit + one flush
    flush_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    require_clean(stats, "graphics")
    if counts["chain_project_1d"] != 1 or counts["chain_project_batch_2d"] != 1 \
            or stats["launches"] != 1 or stats["buckets"] != 1:
        raise SystemExit(f"graphics: expected one flat and one batch launch, "
                         f"got {counts}, {stats['launches']} launches in "
                         f"{stats['buckets']} buckets")
    if off_vector_buckets(srv.last_report):
        raise SystemExit("graphics: the frames' bucket runs the scalar "
                         "batch kernel")

    out, mask = out.cpu().numpy(), mask.cpu().numpy()
    ref, ref_mask = (t.cpu().numpy() for t in
                     chain.project(cloud_dev, backend="ref"))
    if not (bitwise_equal(out, ref) and bitwise_equal(mask, ref_mask)):
        raise SystemExit("graphics: projected cloud != plain version")
    ok, undecided = project_oracle_ok(chain.fold(), cloud, out, mask)
    if not ok:
        raise SystemExit("graphics: cloud outside the float64 bound")
    ref_frames = serving.GeometryServer(device=device, backend="ref") \
        .serve(frames)
    for i, ((c, pts), got) in enumerate(zip(frames, served)):
        q, m = c.project(torch.from_numpy(pts).to(device))
        undecided += check_result(f"frame {i}", c, pts, got, ref_frames[i],
                                  q.cpu().numpy(), m.cpu().numpy())
    summary = {"phase": "graphics", "structure": srv.last_report[0].structure,
               "cloud_points": CLOUD_POINTS,
               "cloud_inside": int(mask.sum()),
               "project_ms": project_s * 1e3,
               "frames": FRAMES, "frame_points": FRAME_POINTS,
               "frames_inside": int(sum(int(r.mask.sum()) for r in served)),
               "serve_ms": flush_s * 1e3,
               "device_span_ms": srv.last_timing.get("device_ms"),
               "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
               "fold_oracle": True, "mask_points_within_bound": undecided}
    return counts, summary


# -- the scene graph on the serving path -------------------------------------

def scene_serve(srv, g, names, pts) -> list:
    """One frame's serve: every leaf as q8.7 and as float32 through
    ``submit_scene``, and as float32 through ``submit`` of its world
    chain (its twin), in one flush; three results a leaf, in order."""
    for n, p in zip(names, pts):
        srv.submit_scene(g, n, p, qformat=Q8_7.name)
        srv.submit_scene(g, n, p)
        srv.submit(g.world_chain(n), p)
    return srv.flush()


def scene_plain_serve(srv, g, names, pts) -> list:
    """``scene_serve``'s frame through ``submit`` of each leaf's world
    chain alone, in the same order and buckets, so a ``backend="ref"``
    server gives the plain versions' results of every scene request
    without touching the scene's fold counters."""
    for n, p in zip(names, pts):
        chain = g.world_chain(n)
        srv.submit(chain, p, qformat=Q8_7.name)
        srv.submit(chain, p)
        srv.submit(chain, p)
    return srv.flush()


def scene_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The scene graph (``repro_torch.scene``) on the serving path:
    ``benchmarks/scene_bench.py``'s two animated scenes (copied in
    ``tests/torch_scenes.py``) at ``torch_scenes.CARD`` -- world ->
    camera -> 8 branch roots -> 64 leaves each, 16 384 points a leaf, 30
    frames -- the diag scene in 2D and the matrix scene in 3D under a
    rotating camera.  A warm frame, then each frame re-poses one branch
    root and serves every leaf (``scene_serve``) in one flush on the
    card, launch counts zeroed just before the flush and read just after.
    Gates, every frame: folds == dirtied nodes; each scene result
    bitwise equal to its ``submit(world_chain)`` twin and to the same
    frame on a ``backend="ref"`` server on the card
    (``scene_plain_serve``: the batch kernels' plain versions on the
    same inputs, in the same buckets); float32 results bitwise equal to
    per-request ``apply`` and q8.7 results to the numpy Qm.n oracle
    (both on a fresh fold of the world chain, recomputed when the leaf's
    world digest changes); after the frames, the counters
    exactly ``torch_scenes.CARD_COUNTERS``, no q fallback and no
    recovery step; then one ``submit_scene_async`` burst of the last
    frame, drained, bitwise equal to the sync results.  Returns (launch
    counts of the frames' flushes, the summary)."""
    card = torch_scenes.CARD
    counts = dict.fromkeys(KERNELS, 0)
    summary = {"phase": "scene", **card}
    rng = np.random.default_rng(torch_scenes.SCENE_SEED)
    for kind in ("diag", "matrix"):
        g, names = torch_scenes.BUILD[kind][0](scene, tc, card["branches"],
                                               card["leaves"])
        pts = torch_scenes.leaf_points(rng, len(names), card["points"], g.dim)
        srv = serving.GeometryServer(device=device)
        plain = serving.GeometryServer(device=device, backend="ref")
        scene_serve(srv, g, names, pts)           # plans, cold folds
        scene.reset_stats()
        serving.reset_stats()
        oracles = {}       # leaf -> (world digest, q8.7 oracle, apply)
        kind_counts = dict.fromkeys(KERNELS, 0)
        frame_ms, folds, launches = [], [], []
        for frame in range(1, card["frames"] + 1):
            before = scene.stats["folds"]
            dirtied = torch_scenes.edit(scene, tc, g, kind, frame,
                                        card["branches"])
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = scene_serve(srv, g, names, pts)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = _build.launch_counts()
            for k, v in got.items():
                counts[k] += v
                kind_counts[k] += v
            launches.append(sum(got.values()))
            folds.append(scene.stats["folds"] - before)
            want = scene_plain_serve(plain, g, names, pts)
            if not all(bitwise_equal(a, b) for a, b in zip(res, want)):
                raise SystemExit(f"scene ({kind}): frame {frame} differs "
                                 f"from its plain versions")
            if folds[-1] != dirtied:
                raise SystemExit(f"scene ({kind}): frame {frame} folded "
                                 f"{folds[-1]} nodes, dirtied {dirtied}")
            for i, (n, p) in enumerate(zip(names, pts)):
                q, f, twin = res[3 * i:3 * i + 3]
                digest = g.world_digest(n)
                if n not in oracles or oracles[n][0] != digest:
                    chain = g.world_chain(n)
                    oracles[n] = (digest, q_oracle(chain, p),
                                  chain.apply(p, device=device).cpu().numpy())
                _, want_q, want_f = oracles[n]
                if not (bitwise_equal(f, twin) and bitwise_equal(f, want_f)
                        and bitwise_equal(q, want_q)):
                    raise SystemExit(f"scene ({kind}): frame {frame}, leaf "
                                     f"{n}: a result differs from its twin, "
                                     f"apply or the Q oracle")
        stats = {k: scene.stats[k] for k in torch_scenes.CARD_COUNTERS}
        if stats != torch_scenes.CARD_COUNTERS:
            raise SystemExit(f"scene ({kind}): counters {stats}, pinned "
                             f"{torch_scenes.CARD_COUNTERS}")
        require_clean(serving.stats, f"scene ({kind})")
        if serving.stats["q_fallbacks"]:
            raise SystemExit(f"scene ({kind}): q8.7 requests fell back")
        want_kernels = [BATCH[kind], Q_BATCH[kind]]
        require_launched(kind_counts, want_kernels, f"scene ({kind})")

        # one async burst of the last frame against its sync results
        eng = serving.AsyncGeometryServer(
            device=device, clock=serving.VirtualClock(),
            admission=serving.AdmissionConfig(
                max_queue_depth=3 * len(names), tenant_share=1.0))
        tickets = []
        for n, p in zip(names, pts):
            tickets.append(eng.submit_scene_async(g, n, p,
                                                  qformat=Q8_7.name))
            tickets.append(eng.submit_scene_async(g, n, p))
            tickets.append(eng.submit_async(g.world_chain(n), p))
        eng.drain()
        if not all(bitwise_equal(t.result(), w)
                   for t, w in zip(tickets, res)):
            raise SystemExit(f"scene ({kind}): the async burst differs "
                             f"from the sync frame")
        n_points = 3 * len(names) * card["points"]
        summary[kind] = {
            "nodes": len(g), "leaves": len(names),
            "requests_per_frame": 3 * len(names),
            "points_per_frame": n_points,
            "serve_ms_per_frame": float(np.median(frame_ms)),
            "serve_ms_frames": frame_ms,
            "points_per_s": n_points / float(np.median(frame_ms)) * 1e3,
            "folds_per_frame": folds, "launches_per_frame": launches,
            "counters": stats, "bitwise_vs_plain": True,
            "bitwise_vs_twin_apply_oracle": True,
            "async_burst_bitwise": True,
            "kernels": {k: kind_counts[k] for k in want_kernels}}
        del oracles, res, want, tickets, eng, srv, plain
    return counts, summary


# -- fault tolerance and the async front end ----------------------------------

def kinds_launched(reqs) -> list:
    """The batch kernels a flush of (chain, points, qformat) requests must
    launch: one for each plan kind of the float lane and of the q lane."""
    names = set()
    for chain, _, q in reqs:
        names.add((Q_BATCH if q else BATCH)[chain.plan_kind])
    return sorted(names)


def chaos_soak_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The port's chaos soak on the card: ``run_chaos_soak(seed=11,
    n_requests=64)`` serves the seeded mixed-lane workload under seeded
    injection on the two-rung ladder ("cuda", then "ref", the plain
    version on the card), holds every resolved result bitwise to
    per-request ``apply``/``project`` and must give the JAX package's
    two-rung counters exactly (``tests/torch_chaos.py``).  Returns
    (launch counts of the run, the summary)."""
    serving.reset_stats()
    _build.reset_launch_counts()
    rep = serving.run_chaos_soak(seed=torch_chaos.SEED,
                                 n_requests=torch_chaos.N_REQUESTS,
                                 device=device)
    counts = _build.launch_counts()
    got = rep.counters()
    if rep.backend != "cuda" or got != torch_chaos.TWO_RUNG:
        diff = {k: (got.get(k), v) for k, v in torch_chaos.TWO_RUNG.items()
                if got.get(k) != v}
        raise SystemExit(f"chaos (soak) on {rep.backend}: counters differ "
                         f"from the two-rung reference (got, want): {diff}")
    triples = workload.mixed_lane_workload(torch_chaos.SEED,
                                           torch_chaos.N_REQUESTS)
    require_launched(counts, kinds_launched(triples), "chaos (soak)")
    return counts, {"phase": "chaos (soak)", "backend": rep.backend,
                    **got, "elapsed_ms": rep.elapsed_s * 1e3,
                    "postmortems": len(rep.postmortems),
                    "launches_by_kernel": {k: v for k, v in counts.items()
                                           if v}}


def timed_flush(srv, reqs, out: list | None = None) -> float:
    """Submit every (chain, points) request, then flush; returns the
    flush's seconds alone (the host phases are in ``srv.last_timing``)
    and puts the results in ``out``."""
    for chain, pts in reqs:
        srv.submit(chain, pts)
    t0 = time.perf_counter()
    results = srv.flush()
    flush_s = time.perf_counter() - t0
    if out is not None:
        out.extend(results)
    return flush_s


def chaos_mixed_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The mixed serve's 1024 requests served clean, then under
    ``FaultInjector(seed=11)`` at the soak's rates (no backoff sleeps, so
    the faulted flush's time is the recovery's own work): nothing lost,
    every resolved result bitwise equal to the clean flush's for its
    ticket (masks included), the failed tickets exactly the injector's
    poison tickets.  Returns (launch counts of the faulted run, the
    summary)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=1024, templates=workload.TEMPLATES,
        min_points=1024, max_points=262144)
    clean_srv = serving.GeometryServer(device=device)
    clean_srv.serve(reqs)                            # warm
    serving.reset_stats()
    clean = []
    clean_s = timed_flush(clean_srv, reqs, clean)
    require_clean(serving.stats, "chaos (mixed), clean flush")

    inj = serving.FaultInjector(seed=torch_chaos.SEED, **CHAOS_RATES)
    srv = serving.GeometryServer(
        device=device, injector=inj,
        fault_config=serving.FaultConfig(backoff_base_s=0.0))
    serving.reset_stats()
    _build.reset_launch_counts()
    faulted = []
    faulted_s = timed_flush(srv, reqs, faulted)
    counts = _build.launch_counts()
    stats = dict(serving.stats)

    if len(faulted) != len(reqs):
        raise SystemExit(f"chaos (mixed): {len(faulted)} results for "
                         f"{len(reqs)} requests")
    poison = {t for t in range(len(reqs)) if inj.role(t) == "poison"}
    failed = set()
    for t, (got, want) in enumerate(zip(faulted, clean)):
        if serving.is_error(got):
            if not isinstance(got, serving.LaunchError) or got.ticket != t:
                raise SystemExit(f"chaos (mixed): ticket {t} resolved to "
                                 f"{got!r}")
            failed.add(t)
        elif not isinstance(got, np.ndarray):
            raise SystemExit(f"chaos (mixed): ticket {t} lost")
        elif not bitwise_equal(got, want) or (
                reqs[t][0].is_projective
                and not bitwise_equal(got.mask, want.mask)):
            raise SystemExit(f"chaos (mixed): ticket {t} != its clean "
                             f"result")
    if failed != poison:
        raise SystemExit(f"chaos (mixed): failed tickets {sorted(failed)} "
                         f"!= the poison tickets {sorted(poison)}")
    if not (stats["retries"] and stats["backend_fallbacks"]
            and stats["bisections"] and inj.injected_corruptions):
        raise SystemExit(f"chaos (mixed): a rung of the ladder never ran: "
                         f"{stats}")
    require_launched(counts, kinds_launched([(c, p, None) for c, p in reqs]),
                     "chaos (mixed)")
    roles = {}
    for t in range(len(reqs)):
        roles[inj.role(t)] = roles.get(inj.role(t), 0) + 1
    return counts, {
        "phase": "chaos (mixed)", "requests": len(reqs),
        "roles": {str(k): v for k, v in roles.items()},
        **{k: stats[k] for k in ("launches", "buckets", *RECOVERY_KEYS,
                                 "recovered_requests")},
        "injected_launch_faults": inj.injected_launch_faults,
        "injected_corruptions": inj.injected_corruptions,
        "clean_flush_ms": clean_s * 1e3, "faulted_flush_ms": faulted_s * 1e3,
        "clean_phases": clean_srv.last_timing,
        "faulted_phases": srv.last_timing,
        "lost": 0, "bitwise_vs_clean": True, "failed_are_poison": True}


def traced_flush_phase(device: str = "cuda") -> dict:
    """One mixed flush traced (``obs.Tracer`` on the monotonic clock)
    beside an untraced one, the trace written as Chrome JSON to
    TRACE_PATH; the span stream must count one ``launch`` instant a
    launch and one ``request.resolve`` a request, and, folded by
    ``obs.Profile`` (the autotune phase's check (e)), give as many
    launches as the server counted, each launch's observed bytes exactly
    the cost model's prediction."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=1024, templates=workload.TEMPLATES,
        min_points=1024, max_points=262144)
    srv = serving.GeometryServer(device=device)
    srv.serve(reqs)                                  # warm
    serving.reset_stats()
    plain_s = timed_flush(srv, reqs)
    plain_phases = srv.last_timing
    tracer = obs.Tracer()
    serving.reset_stats()
    with obs.installed(tracer):
        traced_s = timed_flush(srv, reqs)
    if tracer.count("launch") != serving.stats["launches"] \
            or tracer.count("request.resolve") != len(reqs):
        raise SystemExit(f"traced flush: {tracer.count('launch')} launch "
                         f"instants for {serving.stats['launches']} "
                         f"launches")
    prof = obs.Profile.from_tracer(tracer)
    if not prof.byte_ratio_exact \
            or prof.launches != serving.stats["launches"]:
        raise SystemExit(f"traced flush: the profile folds "
                         f"{prof.launches} launches for "
                         f"{serving.stats['launches']}, byte ratio exact "
                         f"{prof.byte_ratio_exact}")
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    obs.dump_chrome_trace(tracer, TRACE_PATH)
    return {"phase": "traced flush", "events": tracer.n_events,
            "profile": prof.counters(),
            "spans": tracer.n_spans, "untraced_flush_ms": plain_s * 1e3,
            "traced_flush_ms": traced_s * 1e3,
            "untraced_phases": plain_phases, "traced_phases": srv.last_timing,
            "trace": os.path.relpath(TRACE_PATH, ROOT)}


def async_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The async front end on the card.  First the mixed workload is
    submitted under a frozen ``VirtualClock`` and drained: bitwise equal
    to one synchronous flush, with equal launches and launch bytes.  Then
    the JAX package's Poisson soak under a ``VirtualClock``
    (``tests/torch_chaos.py``: its driver and documented settings, 20 000
    arrivals at 150 000/s over four tenants, token buckets that must
    fire): its counters must equal the reference's exactly, nothing
    lost; its host seconds are reported.  Returns (launch counts of the
    soak, the summary)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=1024, templates=workload.TEMPLATES,
        min_points=1024, max_points=262144)
    serving.reset_stats()
    sync = serving.GeometryServer(device=device)
    with opcount.counting() as sync_bytes:
        want = sync.serve(reqs)
    sync_stats = dict(serving.stats)
    serving.reset_stats()
    eng = serving.AsyncGeometryServer(
        device=device, clock=serving.VirtualClock(),
        admission=serving.AdmissionConfig(max_queue_depth=len(reqs),
                                          tenant_share=1.0))
    tickets = [eng.submit_async(c, p) for c, p in reqs]
    with opcount.counting() as async_bytes:
        eng.drain()
    for i, (t, w) in enumerate(zip(tickets, want)):
        got = t.result()
        if not bitwise_equal(got, w) or (
                reqs[i][0].is_projective and not bitwise_equal(got.mask,
                                                                w.mask)):
            raise SystemExit(f"async: ticket {i} drained != sync flush")
    if serving.stats["launches"] != sync_stats["launches"] \
            or async_bytes != sync_bytes \
            or eng.server.last_report != sync.last_report:
        raise SystemExit("async: the drain's launches or bytes differ from "
                         "the synchronous flush's")

    # the Poisson soak: the JAX package's soak driver and settings,
    # copied (tests/torch_chaos.py), its counters exactly the reference's
    serving.reset_stats()
    _build.reset_launch_counts()
    soak = torch_chaos.drive_soak(torch_chaos.SOAK_ARRIVALS, device=device)
    counts = _build.launch_counts()
    got = {k: soak[k] for k in torch_chaos.SOAK}
    if got != torch_chaos.SOAK:
        diff = {k: (got[k], v) for k, v in torch_chaos.SOAK.items()
                if got[k] != v}
        raise SystemExit(f"async: the Poisson soak's counters differ from "
                         f"the reference's (got, want): {diff}")
    require_clean(serving.stats, "async")
    pool = workload.mixed_lane_workload(torch_chaos.SOAK_SEED,
                                        torch_chaos.SOAK_POOL,
                                        max_points=torch_chaos.SOAK_MAX_POINTS)
    require_launched(counts, kinds_launched(pool), "async")
    return counts, {
        "phase": "async", "drain_bitwise_vs_sync": True,
        "drain_launches": sync_stats["launches"],
        "drain_bytes": opcount.total_bytes(async_bytes),
        "soak": got, "soak_equals_reference": True,
        "host_s": soak["wall_s"],
        "host_us_per_arrival": soak["wall_s"] / soak["requests"] * 1e6}


# -- autotune -----------------------------------------------------------------------

def _outs(r) -> tuple:
    return r if isinstance(r, tuple) else (r,)


def knob_checks(largest_affine: dict, largest: dict, largest_q: dict,
                device: str = "cuda") -> tuple[list, dict]:
    """Autotune (a): every candidate of every tunable kernel once at the
    served shapes, held to the default config.  Returns (the chain
    shapes as (kernel, shape), the summary)."""
    dev = torch.device(device)
    backend = dispatch.backend_for(dev)
    single = [(k, (n, d)) for k in search._SINGLE
              for n in TUNE_FLAT_POINTS for d in (2, 3)]
    batch = [("chain_diag_batch", largest_affine["diag"]),
             ("chain_apply_batch", largest_affine["matrix"]),
             ("chain_project_batch", largest["projective"]),
             ("chain_project_batch", (FRAMES, FRAME_POINTS, 3)),
             ("chain_diag_batch_q", largest_q["diag"]),
             ("chain_apply_batch_q", largest_q["matrix"])]
    launched = 0
    for kernel, shape in single + batch:
        run = search._chain_entry(kernel, backend, dev, shape,
                                  "q8.7" if kernel.endswith("_q")
                                  else "float32")
        want = _outs(run(autotune.DEFAULTS[kernel]))
        cands = search.chain_candidates(kernel) if kernel in search._SINGLE \
            else search.chain_batch_candidates(kernel) \
            + search.chain_batch_candidates(kernel, vectors=False)
        for cfg in cands:
            got = _outs(run(cfg))
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"autotune: {kernel} {shape} under "
                                 f"{cfg.describe()} != the default config")
            launched += 1
        del run, want
    mm_rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for m, k, n in TUNE_MATMULS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
        want = matrix_ref.matmul(x, y)
        bound = bounds.matmul_bound(x, y, want)
        default = matmul_op(x, y)
        own_bn = costmodel.matmul_bn(m, n)
        for cfg in search.matmul_candidates():
            got = matmul_op(x, y, config=cfg)
            if not bool(((got.float() - want.float()).abs() <= bound).all()):
                raise SystemExit(f"autotune: matmul_2d {(m, k, n)} under "
                                 f"{cfg.describe()} outside matmul_bound")
            same = same_bits(got, default)
            if cfg.bn == own_bn and not same:
                raise SystemExit(f"autotune: matmul_2d {(m, k, n)} under "
                                 f"{cfg.describe()} != the default config "
                                 f"at its own BN")
            mm_rows.append({"shape": [m, k, n], "config": cfg.describe(),
                            "bitwise_vs_default": same})
            launched += 1
    m, n = TUNE_RMSNORM
    x = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.rand(n, generator=gen, device=dev) + 0.5
    want = rms_ref.rmsnorm(x, g, 1e-6)
    default = rmsnorm_op(x, g)
    own = costmodel.rmsnorm_warps(m, n * 2 // 16)
    rms_rows = []
    for cfg in search.rmsnorm_candidates():
        if not costmodel.rmsnorm_cost(m, n, cfg, itemsize=2).feasible:
            continue
        got = rmsnorm_op(x, g, config=cfg)
        if not bool(((got.float() - want.float()).abs()
                     <= bounds.rmsnorm_bound(want, n)).all()):
            raise SystemExit(f"autotune: rmsnorm_2d under {cfg.describe()} "
                             f"outside rmsnorm_bound")
        same = same_bits(got, default)
        if cfg.row_warps == own and not same:
            raise SystemExit("autotune: rmsnorm_2d at its own row_warps != "
                             "the default config")
        rms_rows.append({"row_warps": cfg.row_warps,
                         "bitwise_vs_default": same})
        launched += 1
    return single + batch, {
        "launches": launched, "chain_shapes": len(single + batch),
        "chain_bitwise_vs_default": True, "matmul_2d": mm_rows,
        "rmsnorm_2d": rms_rows}


def _decision(rep, shape) -> dict:
    return {"kernel": rep.kernel, "dtype": rep.dtype, "shape": list(shape),
            "default_ms": rep.default_seconds * 1e3,
            "winner": rep.winner.describe(),
            "winner_ms": rep.winner_seconds * 1e3, "trials": len(rep.trials)}


def autotune_phase(largest_affine: dict, largest: dict, largest_q: dict,
                   device: str = "cuda", n_requests: int = 1024,
                   max_points: int = 262144) -> dict:
    """The autotune phase (the module docstring's phase 10 (a)-(d)).
    Leaves tuning disabled and the process's cache unset."""
    t0 = time.perf_counter()
    chain_shapes, checks = knob_checks(largest_affine, largest, largest_q,
                                       device)
    emit({"phase": "autotune (knobs)", **checks})

    # (b) the tuners at those shapes and the serving grid
    cache = autotune.TuningCache()
    decisions = []
    for kernel, shape in chain_shapes:
        dtype = "q8.7" if kernel.endswith("_q") else "float32"
        if kernel in search._SINGLE:
            rep = search.tune_chain(kernel, n_points=shape[0], d=shape[1],
                                    dtype=dtype, device=device, cache=cache,
                                    keep=9, iters=TUNE_ITERS)
        else:
            bsz, lpad, d = shape
            rep = search.tune_chain_batch(kernel, bsz=bsz, lpad=lpad, d=d,
                                          dtype=dtype, device=device,
                                          cache=cache, keep=9,
                                          iters=TUNE_ITERS)
        decisions.append(_decision(rep, shape))
    for m, k, n in TUNE_MATMULS:
        decisions.append(_decision(search.tune_matmul(
            m=m, k=k, n=n, device=device, cache=cache, keep=6,
            iters=TUNE_ITERS), (m, k, n)))
    decisions.append(_decision(search.tune_rmsnorm(
        m=TUNE_RMSNORM[0], n=TUNE_RMSNORM[1], dtype="bfloat16",
        device=device, cache=cache, keep=6, iters=TUNE_ITERS), TUNE_RMSNORM))
    reqs = workload.random_workload(
        seed=SEED, n_requests=n_requests, templates=workload.TEMPLATES,
        min_points=1024, max_points=max_points)
    grid = search.tune_serving_grid(reqs, device=device, cache=cache)
    decisions.append(_decision(grid, (len(reqs),)))
    for row in decisions:
        emit({"phase": "autotune (tune)", **row})
    os.makedirs(os.path.dirname(TUNED_CACHE_PATH), exist_ok=True)
    cache.save(TUNED_CACHE_PATH)

    # (c) the mixed serve, untuned and tuned, in turns
    untuned = serving.GeometryServer(device=device)
    tuned = serving.GeometryServer(device=device)
    runs = {}
    for label in ("default", "tuned", "tuned", "default"):
        srv = tuned if label == "tuned" else untuned
        if label == "tuned":
            tcache.set_cache(cache)
        autotune.set_enabled(label == "tuned")
        if label not in runs:
            srv.serve(reqs)                          # warm once each
        serving.reset_stats()
        out = []
        flush_s = timed_flush(srv, reqs, out)
        require_clean(serving.stats, f"autotune ({label} serve)")
        run = runs.setdefault(label, {
            "out": out, "launches": serving.stats["launches"],
            "padded_points": serving.stats["padded_points"],
            "grid": [srv.min_len, srv.waste_cap, srv.grid_source],
            "flush_ms": []})
        run["flush_ms"].append(flush_s * 1e3)
    autotune.set_enabled(True)
    for i, ((chain, pts), got, want) in enumerate(
            zip(reqs, runs["tuned"]["out"], runs["default"]["out"])):
        x = torch.from_numpy(pts).to(device)
        if chain.is_projective:
            q, m = (t.cpu().numpy() for t in chain.project(x))
            ok = bitwise_equal(got.mask, want.mask) \
                and bitwise_equal(got.mask, m)
        else:
            q, ok = chain.apply(x).cpu().numpy(), True
        if not (ok and bitwise_equal(got, want) and bitwise_equal(got, q)):
            raise SystemExit(f"autotune: request {i} under tuning != the "
                             f"untuned serve or per-request apply/project")

    # (d) tuning disabled: the defaults again
    autotune.set_enabled(False)
    for kernel, cfg in autotune.DEFAULTS.items():
        for n in (0, 16384, N_FLAT):
            if tcache.config_for(kernel, dispatch.backend_for(
                    torch.device(device)), "float32", n) is not cfg:
                raise SystemExit(f"autotune: {kernel} is not its default "
                                 f"with tuning disabled")
    tcache.set_cache(None)
    autotune.set_enabled(None)
    return {"phase": "autotune (serve)", "requests": len(reqs),
            **{f"{label}_{k}": run[k] for label, run in runs.items()
               for k in ("launches", "padded_points", "grid", "flush_ms")},
            "bitwise_vs_untuned": True, "bitwise_vs_per_request": True,
            "defaults_when_disabled": True, "cache": os.path.relpath(
                TUNED_CACHE_PATH, ROOT),
            "seconds": time.perf_counter() - t0}


# -- the paper's primitives ------------------------------------------------------

def emulator_phase() -> dict:
    """The paper's routines on the port's M1 emulator, run as
    ``benchmarks/paper_tables.py::_emulator_cycles`` runs them (the same
    seed and draws): every value equal to its int16 oracle, every M1
    cycle count beside Table 5's, matching exactly where the paper prints
    a listing (``EMULATOR_EXACT``) and not elsewhere."""
    rng = np.random.default_rng(0)
    cycles = {}
    for n in (8, 64):
        u = rng.integers(-1000, 1000, n)
        v = rng.integers(-1000, 1000, n)
        rt = programs.run_translation(u, v)
        rs = programs.run_scaling(u, 5)
        if not (np.array_equal(rt.values, programs.oracle_translation(u, v))
                and np.array_equal(rs.values, programs.oracle_scaling(u, 5))):
            raise SystemExit(f"emulator: n={n} values != int16 oracles")
        cycles["translation", n], cycles["scaling", n] = rt.cycles, rs.cycles
    a = rng.integers(-100, 100, (8, 8))
    b = rng.integers(-1000, 1000, (8, 8))
    rm = programs.run_matmul(a, b)
    pts = rng.integers(-100, 100, (2, 8))
    rr = programs.run_rotation_points((3, 4), pts)
    if not (np.array_equal(rm.values, programs.oracle_matmul(a, b))
            and np.array_equal(rr.values, programs.oracle_matmul(
                np.array([[3, -4], [4, 3]]), pts))):
        raise SystemExit("emulator: matmul / composite II != int16 oracle")
    cycles["rotation_matmul", 64] = rm.cycles
    cycles["composite_ii", 16] = rr.cycles
    rows, perf_rows = [], []
    for row in intel.PAPER_TABLE5:
        if row.system != "m1":
            continue
        key = (row.algorithm, row.n_elements)
        match = cycles[key] == row.cycles
        if match != (key in EMULATOR_EXACT):
            raise SystemExit(f"emulator: {key} {cycles[key]} cycles against "
                             f"the paper's {row.cycles}: match={match}")
        rows.append({"algorithm": row.algorithm, "n": row.n_elements,
                     "cycles": cycles[key], "paper_cycles": row.cycles,
                     "match": match})
        perf_rows.append(analysis.derive(row.algorithm, "m1", row.n_elements,
                                         cycles[key], source="emulator"))
    print(analysis.format_table(perf_rows), flush=True)
    return {"phase": "emulator", "values_equal_oracles": True, "m1": rows}


def exact_pipeline(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the float64 value of the exact pipeline ((p + T2) * SV) @ R(THETA)
    + T1, and 4 eps32 mag_c with mag_c = sum_m (|p_m| + |T2_m|) |SV_m|
    |R_mc| + |T1_c|): each primitive's rounding, the float32 fold and the
    float32 cos/sin add at most eps32 / 2 to eps32 of mag_c each."""
    p = pts.astype(np.float64)
    t1, t2, s = (np.array(v, np.float64) for v in (T1, T2, SV))
    c, sn = math.cos(THETA), math.sin(THETA)
    r = np.array([[c, sn], [-sn, c]])
    mag = ((np.abs(p) + np.abs(t2)) * np.abs(s)) @ np.abs(r) + np.abs(t1)
    return ((p + t2) * s) @ r + t1, 4 * EPS32 * mag


def sequential(x: torch.Tensor, t2, sv, t1,
               backend: str | None = None) -> torch.Tensor:
    """kernel_bench.py's sequential pipeline: four eager primitives."""
    q = te.translate(x, t2, backend=backend)
    q = te.scale(q, sv, backend=backend)
    q = te.rotate(q, THETA, backend=backend)
    return te.translate(q, t1, backend=backend)


def primitives_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The eager primitives on a CLOUD_POINTS cloud, then the sequential
    pipeline against the fused chain (see the module docstring).  Returns
    (launch counts of the two eager runs, summed, the summary)."""
    rng = np.random.default_rng(SEED)
    pts = {d: (rng.standard_normal((CLOUD_POINTS, d)) * 4).astype(np.float32)
           for d in (2, 3)}
    other = rng.standard_normal((CLOUD_POINTS, 2)).astype(np.float32)
    s = {d: rng.uniform(-2, 2, d).astype(np.float32) for d in (2, 3)}
    t = {d: rng.uniform(-3, 3, d).astype(np.float32) for d in (2, 3)}
    x = {d: torch.from_numpy(p).to(device) for d, p in pts.items()}
    z = torch.from_numpy(other).to(device)
    c, sn = math.cos(THETA), math.sin(THETA)
    rot = np.array([[c, sn], [-sn, c]])
    p64 = {d: p.astype(np.float64) for d, p in pts.items()}
    s64 = {d: v.astype(np.float64) for d, v in s.items()}
    t64 = {d: v.astype(np.float64) for d, v in t.items()}
    # name -> (call(backend), float64 value, 4 eps32 x magnitude)
    calls = {}
    for d in (2, 3):
        calls[f"translate d={d}"] = (
            lambda b, d=d: te.translate(x[d], t[d], backend=b),
            p64[d] + t64[d], np.abs(p64[d]) + np.abs(t64[d]))
        calls[f"scale d={d}"] = (
            lambda b, d=d: te.scale(x[d], s[d], backend=b),
            p64[d] * s64[d], np.abs(p64[d] * s64[d]))
    calls["affine d=2"] = (lambda b: te.affine(x[2], s[2], t[2], backend=b),
                           p64[2] * s64[2] + t64[2],
                           np.abs(p64[2] * s64[2]) + np.abs(t64[2]))
    calls["rotate d=2"] = (lambda b: te.rotate(x[2], THETA, backend=b),
                           p64[2] @ rot,
                           np.abs(p64[2]).sum(-1, keepdims=True))
    calls["vecadd d=2"] = (lambda b: te.vecadd(x[2], z, backend=b),
                           p64[2] + other, np.abs(p64[2]) + np.abs(other))
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {name: call(None) for name, (call, _, _) in calls.items()}
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    want = {"affine_2d": 5, "matmul_2d": 1, "vecadd_2d": 1}
    if {k: v for k, v in counts.items() if v} != want:
        raise SystemExit(f"primitives: launches {counts}, expected {want}")
    for name, (call, exact, mag) in calls.items():
        out = outs[name]
        if not same_bits(out, call("ref")):
            raise SystemExit(f"primitives: {name} != plain version on the card")
        got = out.cpu().numpy().astype(np.float64)
        if not (np.isfinite(got).all()
                and (np.abs(got - exact) <= 4 * EPS32 * mag).all()):
            raise SystemExit(f"primitives: {name} outside its float64 bound")

    # the paper's comparison: four primitive passes against one fused pass
    x2 = x[2]
    # the pipeline's vectors staged on the card once, as a caller keeps
    # them: param_tensor hands a tensor on x's device to the kernel as it is
    params = [torch.tensor(v, dtype=torch.float32, device=device)
              for v in (T2, SV, T1)]
    chain = (te.Transform2D.identity(device=device).then_translate(*T2)
             .then_scale(*SV).then_rotate(THETA).then_translate(*T1))
    _build.reset_launch_counts()
    with opcount.counting() as rec_seq:
        seq = sequential(x2, *params)
    torch.cuda.synchronize()
    seq_counts = _build.launch_counts()
    _build.reset_launch_counts()
    with opcount.counting() as rec_fused:
        fused = chain.apply(x2)
    torch.cuda.synchronize()
    fused_counts = _build.launch_counts()
    if {k: v for k, v in seq_counts.items() if v} != {"affine_2d": 3,
                                                      "matmul_2d": 1}:
        raise SystemExit(f"sequential: launches {seq_counts}")
    if {k: v for k, v in fused_counts.items() if v} != {"chain_matrix_1d": 1}:
        raise SystemExit(f"fused: launches {fused_counts}")
    if not (same_bits(seq, sequential(x2, *params, backend="ref"))
            and same_bits(fused, chain.apply(x2, backend="ref"))):
        raise SystemExit("sequential / fused != plain version on the card")
    exact, bound = exact_pipeline(pts[2])
    got_seq = seq.cpu().numpy().astype(np.float64)
    got_fused = fused.cpu().numpy().astype(np.float64)
    for what, got in (("sequential", got_seq), ("fused", got_fused)):
        if not (np.isfinite(got).all() and (np.abs(got - exact) <= bound).all()):
            raise SystemExit(f"{what}: outside 4 eps32 mag of the exact value")
    if not (np.abs(got_seq - got_fused) <= 2 * bound).all():
        raise SystemExit("sequential and fused differ by more than 8 eps32 mag")
    # the calls as a user makes them: each call stages its remaining
    # parameters (translate's 1, scale's 0, the rotation matrix; the
    # chain's folded A and t) with synchronous host-to-device copies, so
    # the event window holds host time too; main() adds the kernels alone
    # from the kernel rows at this shape
    (seq_ms, seq_us), (fused_ms, fused_us) = \
        time_ms(lambda: sequential(x2, *params)), \
        time_ms(lambda: chain.apply(x2))
    for k, v in seq_counts.items():
        counts[k] += v
    seq_bytes, fused_bytes = (opcount.total_bytes(r)
                              for r in (rec_seq, rec_fused))
    summary = {
        "phase": "primitives", "cloud_points": CLOUD_POINTS,
        "eager_calls": list(calls), "eager_first_calls_ms": eager_s * 1e3,
        "bitwise_vs_ref": True, "float64_bound": True,
        "sequential_launches": {k: v for k, v in seq_counts.items() if v},
        "fused_launches": {k: v for k, v in fused_counts.items() if v},
        "sequential_opcount": [op for op, _ in rec_seq],
        "sequential_bytes": seq_bytes, "fused_bytes": fused_bytes,
        "bytes_ratio": seq_bytes / fused_bytes,
        "sequential_call_ms": seq_ms, "fused_call_ms": fused_ms,
        "call_time_ratio": seq_ms / fused_ms,
        "sequential_host_us": seq_us, "fused_host_us": fused_us,
        "max_abs_diff_seq_fused": float(np.abs(got_seq - got_fused).max()),
        "within_8eps_mag": True,
    }
    return counts, summary


# -- the model stack: the serve phases ------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def path_kernels(cfg) -> list:
    """The model kernels a config's serving path launches: ``rope_3d``
    where it uses RoPE, ``ssd_intra`` in the SSM and hybrid families,
    the others always."""
    return [k for k in MODEL_PATH_KERNELS
            if (k != "ssd_intra" or cfg.family in ("ssm", "hybrid"))
            and (k != "rope_3d" or cfg.pos_embed == "rope")]


def expected_launches(cfg, gen: int) -> tuple[dict, dict]:
    """(prefill, decode) launches of the model kernels for a model of L
    layers (and E encoder layers).  A hybrid layer's prefill runs
    rmsnorm_2d 5 times (the attention norm, the SSM's gated norm, the two
    branch gains, the MLP norm), rope_3d twice (q, k), flash_attention_3d
    and ssd_intra once and vecadd_2d twice (two residual adds).  A dense,
    MoE or VLM layer is attention only: rmsnorm_2d twice (the attention
    and MLP norms), rope_3d twice, flash_attention_3d once, vecadd_2d
    twice (the MoE FFN's products, gathers and combine are torch ops, as
    they are jnp ops in the reference).  An enc-dec decoder layer adds
    cross-attention -- a norm, flash_attention_3d against the encoder's
    keys and a residual add -- and has no RoPE (sinusoidal positions, a
    torch add); its prefill also runs the encoder, 2 norms, a flash and
    2 adds a layer, and the encoder's final norm.  The final norm adds
    one rmsnorm_2d.  A decode step is the same without the encoder, the
    self-attention's flash and SSD (``_cached_attention`` and the
    recurrent step are plain torch); cross-attention keeps its flash."""
    L, E, enc = cfg.n_layers, cfg.encoder_layers, int(cfg.is_encdec)
    norms = 5 if cfg.family == "hybrid" else 2 + enc
    step = {"rmsnorm_2d": norms * L + 1,
            "rope_3d": 2 * L if cfg.pos_embed == "rope" else 0,
            "flash_attention_3d": enc * L, "ssd_intra": 0,
            "vecadd_2d": (2 + enc) * L}
    prefill = dict(step, rmsnorm_2d=step["rmsnorm_2d"] + 2 * E + enc,
                   flash_attention_3d=L + enc * L + E,
                   ssd_intra=L if cfg.family == "hybrid" else 0,
                   vecadd_2d=step["vecadd_2d"] + 2 * E)
    return prefill, {k: gen * v for k, v in step.items()}


def init_params(cfg, device: str = "cuda") -> tuple[dict, float]:
    """Random parameters of ``cfg`` from seed SEED on the card, and the
    seconds they took."""
    t0 = time.perf_counter()
    params = build(cfg).init(torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def teacher_forced(model, params: dict, prompts: np.ndarray,
                   tokens: np.ndarray,
                   device: str = "cuda") -> tuple[list, int]:
    """``model`` fed ``prompts`` through ``serve_inputs`` (the serve's
    batch, first position and encoder length) and then ``tokens`` (B,
    gen), one a step: the logits of the prefill and of every decode step,
    and the bytes of its cache."""
    b, s = prompts.shape
    batch, pos, enc_len = serve_inputs(
        model.cfg, torch.from_numpy(prompts).long().to(device))
    cache = model.init_cache(b, s + tokens.shape[1], enc_len, device=device)
    nbytes = _tree_bytes(cache)
    tok = torch.from_numpy(tokens).long().to(device)
    lg, cache = model.prefill(params, batch, cache)
    logits = [lg]
    for i in range(tokens.shape[1]):
        lg, cache = model.decode(params, tok[:, i], pos + i, cache)
        logits.append(lg)
    if device == "cuda":
        torch.cuda.synchronize()
    return logits, nbytes


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(RMS(a - b) / RMS(b), the RMS of b), in float64."""
    d, b = (a - b).double(), b.double()
    scale = float(b.pow(2).mean().sqrt())
    return float(d.pow(2).mean().sqrt()) / scale, scale


def logits_gates(logits: list, ref_logits: list, rtol: float, ref: str,
                 failures: list) -> tuple:
    """``model_phase``'s gates of each step's logits against ``ref``'s,
    the same inputs: the relative RMS within ``rtol``, and each greedy
    token equal to the reference's unless the reference's top two logits
    stand within ``rtol`` times the RMS of its logits (a near-tie).  A
    failed gate is appended to ``failures``.  Returns (relative RMS, max
    abs difference, token agreement, near-tie rows, differing tokens),
    each a step."""
    rel_rms, max_abs, agree, ties, differ = [], [], [], [], []
    for step, (a, b) in enumerate(zip(logits, ref_logits)):
        rms, scale = _rel_rms(a, b)
        rel_rms.append(rms)
        max_abs.append(float((a - b).abs().max()))
        same = a.argmax(-1) == b.argmax(-1)
        agree.append(float(same.double().mean()))
        top2 = b.double().topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        tie = rtol * scale
        ties.append(int((margin <= tie).sum()))
        for row in torch.nonzero(~same).flatten().tolist():
            differ.append({"step": step, "row": row,
                           "plain_margin": float(margin[row]),
                           "near_tie_margin": tie,
                           "near_tie": bool(margin[row] <= tie)})
    if max(rel_rms) > rtol:
        failures.append(f"logits {max(rel_rms)} (relative RMS) from the "
                        f"{ref}, above {rtol}")
    beyond = [t for t in differ if not t["near_tie"]]
    if beyond:
        failures.append(f"greedy tokens differ from the {ref}'s beyond a "
                        f"near-tie: {beyond}")
    return rel_rms, max_abs, agree, ties, differ


def model_phase(cfg, *, prompt: int = MODEL_PROMPT,
                weights: tuple[dict, float] | None = None,
                device: str = "cuda") -> tuple[dict, dict, dict]:
    """Serve ``cfg`` from random weights (seed 0; ``weights``, the
    (params, init_s) of ``init_params``, if given): batch MODEL_BATCH, ``prompt``-token prompts
    (whisper-medium: ``prompt`` encoder frames), MODEL_GEN tokens through
    ``serve_batch``'s compiled step (CUDA graphs), launch counts zeroed
    before it and read after the prefill and after the decode; held to
    one ``eager=True`` serve of the same prompts (``compiled_gates``:
    tokens and every step's logits bit for bit, the launches, decode
    sizes that do not depend on the position), with
    ``set_sync_debug_mode("error")`` from the first replay to the end of
    the decode loop; a second serve (replays only, no capture) must give
    the same tokens and logits bit for bit; then the same model on the plain
    versions (``use_backend("ref")``) teacher-forced with the kernel
    path's tokens.  Gates against the plain path, every step: the logits
    within ``logits_rtol(cfg)`` (relative RMS), and each greedy token
    equal to the plain path's unless the plain path's top two logits
    stand within the envelope's RMS difference, ``logits_rtol(cfg)``
    times the RMS of its logits (a near-tie: a threshold fixed by the
    plain path and the per-site bound, not by this run's disagreement).
    A failed gate does not stop the others; the phase fails with all of
    them.  With an int8 KV cache it also prints, ungated, the decode
    logits' relative RMS against the same model with a bfloat16 cache
    (the kernel path, teacher-forced with the same tokens) beside
    ``int8_rms_bound(cfg)``, and the two caches' bytes.  Returns (the
    launches of the first served run, the distinct sizes of those
    launches by kernel, the summary)."""
    model = build(cfg)
    kernels = path_kernels(cfg)
    int8 = cfg.kv_cache_dtype == "int8"
    name = cfg.name + (" int8 KV cache" if int8 else "")
    params, init_s = weights or init_params(cfg, device)
    n_params = sum(t.numel() for t in _leaves(params))
    # the analytic count leaves out conv_b and one of the three per-head
    # SSM vectors (models/config.py): 0.007 % of hymba-1.5b; and the
    # encoder's final norm, 1024 of whisper-medium's 959 M
    if abs(n_params - cfg.param_count()) > 1e-3 * cfg.param_count():
        raise SystemExit(f"{name}: {n_params} parameters, param_count() "
                         f"{cfg.param_count()}")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (MODEL_BATCH, prompt)).astype(np.int32)
    # warm-up (cuBLAS handles, the kernels' first launches, a capture of
    # its own key), not counted; a VLM's warm-up prompt holds its patch
    # prefix
    serve_batch(cfg, params, prompts[:, :max(64, 2 * cfg.n_frontend_tokens)],
                gen_tokens=2, model=model)
    # the eager step (op by op from Python), the compiled step's reference
    eager = serve_counted(cfg, params, prompts, model, eager=True)
    # the compiled step's first serve of this key (the prefill and decode
    # step 0 eager, both graphs captured, then replays) and its second
    # (replays only), no synchronising call from the first replay on
    first = serve_counted(cfg, params, prompts, model, sync_debug="error")
    second = serve_counted(cfg, params, prompts, model, sync_debug="error")
    tokens, trace, wall_s = first["tokens"], first["trace"], first["wall_s"]
    peak, total, sizes = first["peak"], first["total"], first["sizes"]
    pre = trace["launches_prefill"]
    want_pre, want_dec = expected_launches(cfg, MODEL_GEN)
    for run in (first, second, eager):
        pre_r = run["trace"]["launches_prefill"]
        dec_r = {k: run["total"][k] - pre_r[k] for k in run["total"]}
        for kernel in MODEL_PATH_KERNELS:
            if pre_r[kernel] != want_pre[kernel] \
                    or dec_r[kernel] != want_dec[kernel]:
                raise SystemExit(
                    f"{name} ({run['trace']['step']}): {kernel} launched "
                    f"{pre_r[kernel]} + {dec_r[kernel]}, expected "
                    f"{want_pre[kernel]} + {want_dec[kernel]}")
    dec = {k: total[k] - pre[k] for k in total}
    require_launched(total, kernels, f"{name} serve")
    logits = trace["logits"]
    if tokens.shape != (MODEL_BATCH, MODEL_GEN) or not all(
            lg.shape == (MODEL_BATCH, cfg.vocab_size)
            and bool(torch.isfinite(lg).all()) for lg in logits):
        raise SystemExit(f"{name}: bad tokens or non-finite logits")
    failures = compiled_gates(first, second, eager)
    again = second["trace"]
    # the second serve: the same bits (no atomics reorder an add)
    repeat_bitwise = bool(np.array_equal(second["tokens"], tokens)) and all(
        torch.equal(a, b) for a, b in zip(logits, again["logits"]))
    if not repeat_bitwise:
        failures.append("two serves differ")

    # the plain path on the card, teacher-forced with the kernel path's tokens
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        ref_logits, cache_bytes = teacher_forced(model, params, prompts,
                                                 tokens, device)
        if any(_build.launch_counts().values()):
            raise SystemExit(f"{name}: the plain path launched a kernel")
    rtol = logits_rtol(cfg)
    rel_rms, max_abs, agree, ties, differ = logits_gates(
        logits, ref_logits, rtol, "plain path", failures)
    plain_tokens = torch.stack([lg.argmax(-1) for lg in ref_logits[:-1]],
                               dim=1).cpu().numpy()
    if failures:
        raise SystemExit(f"{name}: " + "; ".join(failures))
    decode_ms = trace["decode_ms"]
    summary = {
        "phase": f"serve ({name})", "arch": cfg.name, "family": cfg.family,
        "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
        "params": n_params, "param_count": cfg.param_count(),
        "dtype": cfg.dtype, "kv_cache_dtype": cfg.kv_cache_dtype,
        "batch": MODEL_BATCH, "prompt": prompt, "gen_tokens": MODEL_GEN,
        "init_s": init_s, "prefill_ms": trace["prefill_ms"],
        "prefill_tokens_per_s": MODEL_BATCH * prompt
        / trace["prefill_ms"] * 1e3,
        "decode_ms_per_token": float(np.median(decode_ms)),
        "decode_ms_steps": decode_ms,
        "decode_tokens_per_s": MODEL_BATCH * len(decode_ms)
        / sum(decode_ms) * 1e3,
        "wall_s": wall_s,
        "served_tokens_per_s": MODEL_BATCH * MODEL_GEN / wall_s,
        "peak_memory_GB": peak / 1e9, "cache_bytes": cache_bytes,
        "launches_prefill": {k: pre[k] for k in kernels},
        "launches_decode": {k: dec[k] for k in kernels},
        "logits_rel_rms_vs_plain": rel_rms, "logits_rel_rms_max": max(rel_rms),
        "logits_rtol": rtol, "logits_max_abs_diff": max_abs,
        "greedy_agreement": agree,
        "greedy_agreement_mean": float(np.mean(agree)),
        "tokens_equal_plain": bool(np.array_equal(plain_tokens, tokens)),
        "tokens_differing": differ, "near_tie_rows_by_step": ties,
        "near_tie_rows": sum(ties),
        "tokens_first_row": tokens[0].tolist(),
        "repeat_bitwise": repeat_bitwise,
        "repeat_prefill_ms": again["prefill_ms"],
        "repeat_decode_ms_per_token": float(np.median(again["decode_ms"])),
        "repeat_decode_ms_steps": again["decode_ms"],
        "repeat_wall_s": second["wall_s"],
        "step": trace["step"], "capture_ms": trace["capture_ms"],
        "replay_host_us": float(np.median(trace["replay_us"]
                                          + again["replay_us"])),
        "repeat_peak_memory_GB": second["peak"] / 1e9,
        "eager_prefill_ms": eager["trace"]["prefill_ms"],
        "eager_decode_ms_per_token": float(np.median(
            eager["trace"]["decode_ms"])),
        "eager_decode_ms_steps": eager["trace"]["decode_ms"],
        "eager_wall_s": eager["wall_s"],
        "eager_peak_memory_GB": eager["peak"] / 1e9,
        "compiled_bitwise_vs_eager": True,
    }
    if int8:
        # the same model with a bfloat16 cache, teacher-forced with the
        # int8 serve's tokens, on the kernel path
        bf16_logits, bf16_bytes = teacher_forced(
            build(dataclasses.replace(cfg, kv_cache_dtype="bfloat16")),
            params, prompts, tokens, device)
        vs_bf16 = [_rel_rms(a, b)[0]
                   for a, b in zip(logits[1:], bf16_logits[1:])]
        bound = int8_rms_bound(cfg)
        summary.update({
            "prefill_logits_equal_bf16_cache": bool(
                torch.equal(logits[0], bf16_logits[0])),
            "decode_rel_rms_vs_bf16_cache": vs_bf16,
            "decode_rel_rms_vs_bf16_cache_max": max(vs_bf16),
            "int8_rms_bound": bound,
            "int8_rms_bound_met": max(vs_bf16) <= bound,
            "bf16_cache_bytes": bf16_bytes,
            "cache_bytes_ratio": cache_bytes / bf16_bytes})
        del bf16_logits
    del logits, ref_logits, again, first, second, eager
    release_graphs(model)
    torch.cuda.empty_cache()
    return total, sizes, summary


def serve_counted(cfg, params: dict, prompts: np.ndarray, model,
                  **kw) -> dict:
    """One ``serve_batch`` of MODEL_GEN tokens with a trace, the launch
    counts and the peak memory zeroed before it: {tokens, trace, wall_s,
    peak (bytes), total (launches), sizes (``launch_sizes``)}."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    trace = {}
    t0 = time.perf_counter()
    tokens = serve_batch(cfg, params, prompts, gen_tokens=MODEL_GEN,
                         model=model, trace=trace, **kw)
    wall_s = time.perf_counter() - t0
    return {"tokens": tokens, "trace": trace, "wall_s": wall_s,
            "peak": torch.cuda.max_memory_allocated(),
            "total": _build.launch_counts(), "sizes": _build.launch_sizes()}


def compiled_gates(first: dict, second: dict, eager: dict) -> list:
    """The compiled step's gates (``serve_counted`` runs): both compiled
    serves ran as CUDA graphs, the first captured and the second did
    not; the first's tokens and every step's logits bit for bit the
    eager serve's; each serve's decode steps launched the same sizes at
    every position, the compiled step's the eager step's; the launches
    by kernel equal to the eager serve's.  Returns the failures."""
    failures = []
    t1, t2, te = first["trace"], second["trace"], eager["trace"]
    if t1["step"] != "cuda graph" or t2["step"] != "cuda graph" \
            or te["step"] != "eager":
        failures.append(f"steps {t1['step']}, {t2['step']}, {te['step']}")
    if t1["capture_ms"] is None or t2["capture_ms"] is not None:
        failures.append("the first compiled serve did not capture, or the "
                        "second captured again")
    if not (np.array_equal(first["tokens"], eager["tokens"]) and all(
            torch.equal(a, b) for a, b in zip(t1["logits"], te["logits"]))):
        failures.append("the compiled serve differs from the eager one")
    for run in (first, second, eager):
        steps = run["trace"]["decode_sizes"]
        if any(s != steps[0] for s in steps) or steps[0] != \
                te["decode_sizes"][0]:
            failures.append(f"{run['trace']['step']} decode launch sizes "
                            "depend on the position")
    for run in (first, second):
        if run["total"] != eager["total"]:
            failures.append(f"launches {run['total']}, eager "
                            f"{eager['total']}")
    return failures


def model_case(name: str, shape: tuple, dtype: torch.dtype,
               rng: np.random.Generator, size: str, *, window=None,
               pos0: int = 0, t: int | None = None, causal: bool = True,
               q_offset: int = 0, check_only: bool = False,
               misaligned: bool = False) -> dict:
    """Check one model kernel against its plain version on the card at a
    path shape (rope_3d bit for bit, its tables from position ``pos0``;
    the others within ``torch_bounds``; ``rmsnorm_2d``'s and ``rope_3d``'s
    x one element off 16-byte alignment if ``misaligned``; flash
    attention's (BHq, BHkv, S, D) queries against ``t`` keys, S if None,
    ``causal`` or not, the queries from position ``q_offset``), then time
    it
    unless ``check_only`` beside its
    plain version, one
    PyTorch call where one computes the function (``rms_norm``,
    ``scaled_dot_product_attention`` with the same mask) or a composite
    (RoPE, SSD), its bound and, for a row bound by bytes, a device copy
    of as many bytes (``copy_ms``)."""
    dev = torch.device("cuda")
    item = torch.empty((), dtype=dtype).element_size()

    def randn(*s, scale=1.0, dt=dtype):
        return (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) * scale).to(dt)

    library = "composite"
    if name == "rmsnorm_2d":
        m, n = shape
        x = randn(m, n, scale=3.0)
        if misaligned:
            x = off_alignment(x)
        g = (torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
             .to(dev))
        g_lib = g.to(dtype)
        run = lambda: rms_k.rmsnorm_2d(x, g, eps=1e-5)   # noqa: E731
        plain = lambda: rms_ref.rmsnorm(x, g, 1e-5)      # noqa: E731
        lib = lambda: F.rms_norm(x, (n,), g_lib, 1e-5)   # noqa: E731
        library = "rms_norm"
        nbytes, ops, peak = 2 * m * n * item + 4 * n, 4 * m * n, FP32_OPS_PER_S

        def bound(want):
            return bounds.rmsnorm_bound(want, n)
    elif name == "rope_3d":
        bh, s, d = shape
        x = randn(bh, s, d)
        if misaligned:
            x = off_alignment(x)
        pos = torch.arange(pos0, pos0 + s, device=dev)
        cos, sin = (t.to(dtype).contiguous()
                    for t in rope_ref.rope_tables(pos, d))
        cos_f, sin_f = (torch.cat([t, t], dim=-1) for t in (cos, sin))
        run = lambda: rope_k.rope_3d(x, cos, sin)       # noqa: E731
        plain = lambda: rope_ref.rope(x, cos, sin)      # noqa: E731

        def lib():   # the rotate-half form: x cos + rotate_half(x) sin
            x1, x2 = x[..., :d // 2], x[..., d // 2:]
            return x * cos_f + torch.cat([-x2, x1], dim=-1) * sin_f
        nbytes = 2 * bh * s * d * item + 2 * s * (d // 2) * item
        ops, peak, bound = 6 * bh * s * (d // 2), FP32_OPS_PER_S, None
    elif name == "flash_attention_3d":
        bhq, bhkv, s, d = shape
        t = s if t is None else t
        q, k, v = randn(bhq, s, d), randn(bhkv, t, d), randn(bhkv, t, d)
        scale = d ** -0.5
        run = lambda: fa_k.flash_attention_3d(        # noqa: E731
            q, k, v, scale=scale, causal=causal, window=window,
            q_offset=q_offset)
        plain = lambda: fa_ref.flash_attention(        # noqa: E731
            q, k, v, scale=scale, causal=causal, window=window,
            q_offset=q_offset)
        b = MODEL_BATCH if bhq % MODEL_BATCH == 0 else 1
        q4 = q.view(b, bhq // b, s, d)
        k4, v4 = k.view(b, bhkv // b, t, d), v.view(b, bhkv // b, t, d)
        qp = q_offset + torch.arange(s, device=dev)
        kp = torch.arange(t, device=dev)
        mask = kp[None, :] <= qp[:, None] if causal else \
            torch.ones((s, t), dtype=torch.bool, device=dev)
        if window is not None:
            mask &= kp[None, :] > qp[:, None] - window
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q4, k4, v4, attn_mask=mask, scale=scale, enable_gqa=True)
        library = "scaled_dot_product_attention"
        live = int(mask.sum()) * bhq
        nbytes = (2 * bhq * s * d + 2 * bhkv * t * d) * item
        ops, peak = 4 * d * live, BF16_OPS_PER_S

        def bound(want):
            return bounds.flash_bound(q, k, v, scale, want)
    else:   # ssd_intra
        bc, lc, h, p, n = shape
        xdt = randn(bc, lc, h, p)
        bb, cc = randn(bc, lc, n), randn(bc, lc, n)
        a = -torch.from_numpy(rng.uniform(0.001, 0.1, (bc, lc, h))
                              .astype(np.float32)).to(dev)
        cum = torch.cumsum(a, dim=1)
        run = lambda: ssd_k.ssd_intra(xdt, bb, cc, cum)   # noqa: E731
        plain = lambda: ssd_ref.ssd_intra(xdt, bb, cc, cum)  # noqa: E731
        tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=dev))

        def lib():   # the JAX package's XLA path: bf16 att, bmm-shaped
            g = torch.matmul(cc, bb.transpose(1, 2)).float()
            diff = cum[:, :, None, :] - cum[:, None, :, :]
            decay = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                               float("-inf")))
            att = (g[..., None] * decay).to(dtype)
            y = torch.einsum("cijh,cjhp->cihp", att, xdt).float()
            w = (xdt.float() * torch.exp(cum[:, -1:, :] - cum)[..., None])
            s_c = torch.einsum("cjhp,cjn->chpn", w.to(dtype), bb).float()
            return y, s_c
        pairs = lc * (lc + 1) // 2
        nbytes = (bc * lc * h * p + 2 * bc * lc * n) * item \
            + 4 * bc * lc * h + 4 * bc * lc * h * p + 4 * bc * h * p * n
        ops = bc * h * (pairs * (2 * n + 2 * p + 2) + 2 * lc * p * n)
        peak = BF16_OPS_PER_S
        bound = None
    got, want = run(), plain()
    torch.cuda.synchronize()
    if name == "rope_3d":
        if not same_bits(got, want):
            raise SystemExit(f"{name} {shape}: kernel != plain version")
        err = float((got.float() - want.float()).abs().max())
    elif name == "ssd_intra":
        by, bs = bounds.ssd_bounds(xdt, bb, cc, cum, ssd_ref.ssd_intra,
                                   tensor_cores=True)
        if not (bool(((got[0] - want[0]).abs() <= by).all())
                and bool(((got[1] - want[1]).abs() <= bs).all())):
            raise SystemExit(f"{name} {shape}: kernel outside its bound")
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
    else:
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= bound(want)).all()) \
                or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"{name} {shape}: kernel outside its bound")
        err = float(diff.max())
    row = {"kernel": name, "size": size, "shape": list(shape),
           "dtype": str(dtype).removeprefix("torch."), "window": window,
           "pos0": pos0, "misaligned": misaligned, "within_bound": True,
           "max_abs_err": err}
    if name == "flash_attention_3d":
        row.update(t=t, causal=causal, q_offset=q_offset)
    if check_only:
        emit(row)
        return row
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    composite = library == "composite"
    row.update({"ms": ms, "bytes": nbytes, "ops": ops,
                "copy_ms": copy_ms(nbytes, dev) if byte_ms >= op_ms
                else None,
                "GB/s": nbytes / ms / 1e6, "TFLOP/s": ops / ms / 1e9,
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "plain_ms": plain_ms,
                "library_ms": None if composite else lib_ms,
                "composite_ms": lib_ms if composite else None,
                "library": library, "host_us": host_us,
                "plain_host_us": plain_us, "library_host_us": lib_us})
    emit(row)
    return row


# -- the model stack: training ----------------------------------------------------

def _named(tree, path: str = "") -> list:
    """(path, leaf) pairs of a parameter tree in ``leaves``' order."""
    if isinstance(tree, dict):
        return [it for k, v in tree.items() for it in _named(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [it for i, v in enumerate(tree)
                for it in _named(v, f"{path}/{i}")]
    return [(path, tree)]


def expected_train_launches(cfg, accum: int) -> tuple[dict, dict]:
    """(launches, plain backwards) of the model kernels in one train step
    of a hybrid model of L layers under remat "dots" over ``accum``
    micro-batches.  A forward pass launches rmsnorm_2d 5L+1 times,
    rope_3d 2L, flash_attention_3d and ssd_intra L and vecadd_2d 2L (the
    serve's prefill counts); the backward pass recomputes every layer --
    the kernels are opaque to the selective-checkpoint policy, which
    keeps only the dense products' outputs -- but not the final norm, so
    a step launches each kernel twice its layers' count, rmsnorm_2d
    once more; every forward launch of the kept graph runs one plain
    backward (``kernels.grad``)."""
    L = cfg.n_layers
    fwd = {"rmsnorm_2d": 5 * L + 1, "rope_3d": 2 * L,
           "flash_attention_3d": L, "ssd_intra": L, "vecadd_2d": 2 * L}
    launches = {k: accum * (2 * v - (k == "rmsnorm_2d"))
                for k, v in fwd.items()}
    return launches, {k: accum * v for k, v in fwd.items()}


def _train_batch(cfg, device: str = "cuda") -> tuple[dict, int]:
    """``SyntheticLMData``'s step-0 batch, (accum, micro, ...) on the
    card, and accum."""
    accum = elastic.replan_accum(TRAIN_BATCH, TRAIN_MICRO)
    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED))
    raw = data.global_batch(0)
    return {k: torch.from_numpy(v.reshape((accum, TRAIN_BATCH // accum)
                                          + v.shape[1:])).to(device)
            for k, v in raw.items()}, accum


def train_phase(device: str = "cuda") -> tuple[list, dict, dict]:
    """Train hymba-1.5b at full width and depth (bfloat16, remat "dots")
    on the card, the phase's gates (a)-(d), each failure gathered and the
    phase failed with all of them:

      (a) step 1's loss and gradients (``value_and_grad`` over the two
          micro-batches of ``SyntheticLMData(seed 0)``'s step 0, from
          ``Model.init``'s parameters, seed 0) on the kernel path, and
          the same under ``dispatch.use_backend("ref")``: the launches
          and plain backwards of ``expected_train_launches``, none on the
          plain path; the losses, the relative RMS of all gradients
          flattened together and the global gradient norms within
          ``logits_rtol(cfg)``; every gradient present and finite; the
          worst tensor's relative RMS printed with its name, ungated;
      (b) step 1 (``make_train_step``) twice from the same parameters,
          AdamW state and batch: the same loss and parameters bit for
          bit;
      (c) three steps of ``launch.train.train_loop`` (``AdamWConfig(
          total_steps=3, warmup_steps=1)``) through the compiled step:
          step 1 eager over ``CompiledTrain``'s buffers, a capture of the
          whole step as one CUDA graph, steps 2-3 replays with no
          synchronising call in their enqueue (``sync_debug="error"``):
          every step's launches and plain backwards, replays included,
          as in (a), three finite losses (printed, not required to
          fall), the step's ms (CUDA events; the median of steps 2-3),
          tokens/s, capture ms, host µs a replay and the peak memory
          (before the serves); after step 2 the live weights serve the
          hymba serve's prompts (batch 4, 2048 tokens, 16 generated: a
          capture), after step 3 again -- the key hits, no capture --
          with the tokens of an ``eager=True`` serve of the same weights
          and ``memory_allocated`` within 1 % of after the first serve;
      (d) the distinct sizes of (c)'s launches, for the shape checks;
      (e) the same three steps with ``eager=True`` (the functional step
          op by op): every step's loss, gradient norm and the digests of
          every parameter and optimizer leaf equal to (c)'s, its
          launches and plain backwards as in (a), its ms a step,
          tokens/s and peak memory, and each step's forward, backward
          (recomputation included) and optimizer ms and its plain
          backwards' ms (CUDA events around each Function's vjp).

    The summary carries the card's name and power limit beside its
    figures.  Returns ((c)'s steps with their launches, the sizes, the
    summary, (c)'s and (e)'s steps for phase 8g: their digests and ms,
    (c)'s capture ms, host µs a replay and peak)."""
    cfg = dataclasses.replace(configs.get(HYMBA_ARCH), remat="dots")
    model = build(cfg)
    batch, accum = _train_batch(cfg, device)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    want_launch, want_bwd = expected_train_launches(cfg, accum)
    rtol = logits_rtol(cfg)
    failures = []

    def counted(what: str) -> tuple[dict, dict]:
        got = {k: _build.launch_counts()[k] for k in MODEL_PATH_KERNELS}
        bwd = grad.backward_counts()
        if got != want_launch or bwd != want_bwd:
            failures.append(f"{what}: launches {got} and plain backwards "
                            f"{bwd}, expected {want_launch} and {want_bwd}")
        return got, bwd

    # (a) the kernel path against the plain path
    params, init_s = init_params(cfg, device)
    names = [n for n, _ in _named(params)]
    n_params = sum(t.numel() for t in leaves(params))
    _build.reset_launch_counts()
    grad.reset_backward_counts()
    loss_k, grads_k = value_and_grad(model, params, batch, accum)
    torch.cuda.synchronize()
    launches_a, backwards_a = counted("step 1 (kernel path)")
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        loss_r, grads_r = value_and_grad(model, params, batch, accum)
        torch.cuda.synchronize()
        if any(_build.launch_counts().values()):
            raise SystemExit("train: the plain path launched a kernel")
    gk, gr = leaves(grads_k), leaves(grads_r)
    if len(gk) != len(names) or any(g is None for g in gk):
        failures.append("a parameter got no gradient")
    nonfinite = [n for n, g in zip(names, gk)
                 if g is not None and not bool(torch.isfinite(g).all())]
    if nonfinite:
        failures.append(f"non-finite gradients: {nonfinite}")
    diff2 = sum(float((a.double() - b.double()).pow(2).sum())
                for a, b in zip(gk, gr))
    ref2 = sum(float(b.double().pow(2).sum()) for b in gr)
    grads_rel_rms = math.sqrt(diff2 / ref2)
    per_tensor = [(_rel_rms(a, b)[0], n) for n, a, b in zip(names, gk, gr)
                  if float(b.double().pow(2).sum()) > 0]
    worst_rms, worst_name = max(per_tensor)
    compress = compression_check(grads_k)
    gnorm_k, gnorm_r = float(global_norm(grads_k)), float(global_norm(grads_r))
    loss_rel = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
    gnorm_rel = abs(gnorm_k - gnorm_r) / gnorm_r
    for what, val in (("loss", loss_rel), ("gradients (relative RMS)",
                                           grads_rel_rms),
                      ("global gradient norm", gnorm_rel)):
        if not val <= rtol:
            failures.append(f"{what} {val} from the plain path, above {rtol}")
    del grads_k, grads_r, gk, gr
    torch.cuda.empty_cache()

    # (b) step 1 twice from the same state
    opt_state = adamw_init(params)
    step = make_train_step(model, opt_cfg, accum)
    p1, s1, m1 = step(params, opt_state, batch)
    del s1
    p2, s2, m2 = step(params, opt_state, batch)
    del s2
    repeat_bitwise = torch.equal(m1["loss"], m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(leaves(p1), leaves(p2)))
    if not repeat_bitwise:
        failures.append("step 1 repeated from the same state differs")
    del params, opt_state, p1, p2
    torch.cuda.empty_cache()

    # (c) three steps of the compiled train_loop, the trained weights
    # served after steps 2 and 3; (e) the same three steps eager
    serve_model, served = build(cfg), {}
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (MODEL_BATCH, MODEL_PROMPT)).astype(np.int32)

    def serve_trained(i: int, params) -> None:
        """After step 2 serve the live weights (a capture); after step 3
        serve them again (a replay: the key's tensors were updated in
        place) and once with ``eager=True``."""
        if i == 1:
            served["train_peak"] = torch.cuda.max_memory_allocated()
        if i not in (1, 2):
            return
        trace = {}
        tokens = serve_batch(cfg, params, prompts, gen_tokens=MODEL_GEN,
                             model=serve_model, trace=trace)
        del trace["logits"]
        torch.cuda.synchronize()
        served[i] = {"tokens": tokens, "step": trace["step"],
                     "capture_ms": trace["capture_ms"],
                     "allocated": torch.cuda.memory_allocated(),
                     "prefill_ms": trace["prefill_ms"],
                     "decode_ms": float(np.median(trace["decode_ms"]))}
        if i == 2:
            served["eager_tokens"] = serve_batch(
                cfg, params, prompts, gen_tokens=MODEL_GEN,
                model=serve_model, eager=True)

    def loop(eager: bool) -> dict:
        what = "eager" if eager else "compiled"
        steps, sizes, timing, digests = [], {}, {}, []

        def on_step(i, metrics):
            torch.cuda.synchronize()
            got, bwd = counted(f"{what} train_loop step {i + 1}")
            digests.append((metrics["loss"], float(metrics["grad_norm"]),
                            leaf_digests(metrics["params"]),
                            leaf_digests(metrics["opt_state"])))
            steps.append({"step": i + 1, "loss": metrics["loss"],
                          "ms": metrics["ms"], "lr": metrics["lr"],
                          "grad_norm": float(metrics["grad_norm"]),
                          "launches": got, "plain_backwards": bwd,
                          "spans": len(spans)})
            for k, v in _build.launch_sizes().items():
                sizes.setdefault(k, set()).update(v)
            if not eager:
                serve_trained(i, metrics["params"])
            _build.reset_launch_counts()
            grad.reset_backward_counts()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        grad.reset_backward_counts()
        trace = {}
        t0 = time.perf_counter()
        with grad.timed() as spans:
            _, history = train_loop(
                cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, micro_per_shard=TRAIN_MICRO,
                opt_cfg=opt_cfg, seed=SEED, device=device, on_step=on_step,
                timing=timing, log_every=1, eager=eager, trace=trace,
                sync_debug=None if eager else "error")
            wall_s = time.perf_counter() - t0
            peak = served.get("train_peak") if not eager else None
            peak = peak or torch.cuda.max_memory_allocated()
            bounds_ = [0] + [row.pop("spans") for row in steps]
            split = len(timing.get("optimizer", ()))   # steps run op by op
            for i, row in enumerate(steps[:split]):
                row["plain_backward_ms"] = grad.elapsed_ms(
                    spans[bounds_[i]:bounds_[i + 1]])
                for part in ("forward", "backward", "optimizer"):
                    per = accum if part != "optimizer" else 1
                    row[f"{part}_ms"] = sum(
                        a.elapsed_time(b)
                        for a, b in timing[part][i * per:(i + 1) * per])
                row["plain_backward_share"] = \
                    row["plain_backward_ms"] / row["ms"]
        if len(history) != TRAIN_STEPS or not all(math.isfinite(x)
                                                  for x in history):
            failures.append(f"{what} losses {history}: not {TRAIN_STEPS} "
                            "finite ones")
        later = steps[1:]
        step_ms = float(np.median([r["ms"] for r in later]))
        out = {"step": trace["step"], "losses": history, "step_ms": step_ms,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               "peak_memory_GB": peak / 1e9, "wall_s": wall_s,
               "capture_ms": trace["capture_ms"],
               "replay_host_us": trace["replay_us"], "steps": steps}
        if eager:
            for key in ("forward_ms", "backward_ms", "optimizer_ms",
                        "plain_backward_ms", "plain_backward_share"):
                out[key] = float(np.median([r[key] for r in later]))
        torch.cuda.empty_cache()
        return {"summary": out, "sizes": sizes, "digests": digests}

    compiled = loop(eager=False)
    release_graphs(serve_model)    # the served weights go with it
    eager = loop(eager=True)
    steps, sizes = compiled["summary"]["steps"], compiled["sizes"]
    if compiled["summary"]["step"] != "cuda graph" \
            or eager["summary"]["step"] != "eager":
        failures.append(f"steps {compiled['summary']['step']}, "
                        f"{eager['summary']['step']}")
    off = [i + 1 for i, (a, b) in enumerate(zip(compiled["digests"],
                                                 eager["digests"])) if a != b]
    if off or len(compiled["digests"]) != len(eager["digests"]):
        failures.append(f"compiled steps {off} differ from the eager loop's "
                        "(loss, gradient norm, parameters, optimizer state)")
    if len(compiled["summary"]["replay_host_us"]) != TRAIN_STEPS - 1:
        failures.append("the compiled loop did not replay its later steps")
    if served[1]["capture_ms"] is None or served[2]["capture_ms"] is not None \
            or served[2]["step"] != "cuda graph":
        failures.append("the serve after a compiled train step captured "
                        "again, or the first serve did not capture")
    if not np.array_equal(served[2]["tokens"], served["eager_tokens"]):
        failures.append("the serve after a compiled train step differs from "
                        "an eager serve of the same weights")
    grew = served[2]["allocated"] / served[1]["allocated"] - 1
    if abs(grew) > 0.01:
        failures.append(f"memory_allocated moved {grew:.4f} between the "
                        "serves around a compiled train step")
    loop_8f = {"digests": compiled["digests"],
               "eager_digests": eager["digests"],
               "ms": [r["ms"] for r in steps],
               "eager_ms": [r["ms"] for r in eager["summary"]["steps"]],
               "step_ms": compiled["summary"]["step_ms"],
               "capture_ms": compiled["summary"]["capture_ms"],
               "replay_host_us": compiled["summary"]["replay_host_us"],
               "peak_memory_GB": compiled["summary"]["peak_memory_GB"]}
    if failures:
        raise SystemExit("train (hymba-1.5b): " + "; ".join(failures))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    c, e = compiled["summary"], eager["summary"]
    summary = {
        "phase": f"train ({cfg.name})", "arch": cfg.name,
        "layers": cfg.n_layers, "params": n_params,
        "dtype": cfg.dtype, "remat": cfg.remat,
        "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "accum": accum,
        "tokens_per_step": tokens, "init_s": init_s,
        "step1_loss_kernel": float(loss_k), "step1_loss_plain": float(loss_r),
        "step1_loss_rel_diff": loss_rel,
        "grads_rel_rms_vs_plain": grads_rel_rms,
        "grad_norm_kernel": gnorm_k, "grad_norm_plain": gnorm_r,
        "grad_norm_rel_diff": gnorm_rel, "rtol": rtol,
        "worst_tensor_rel_rms": worst_rms, "worst_tensor": worst_name,
        "launches_step1": launches_a, "plain_backwards_step1": backwards_a,
        "expected_launches": want_launch,
        "expected_plain_backwards": want_bwd,
        "repeat_bitwise": repeat_bitwise, "losses": c["losses"],
        "compression_int8": compress,
        "compiled_bitwise_eager": True, "step_ms": c["step_ms"],
        "tokens_per_s": c["tokens_per_s"], "capture_ms": c["capture_ms"],
        "replay_host_us": c["replay_host_us"],
        "peak_memory_GB": c["peak_memory_GB"], "compiled": c,
        "eager_step_ms": e["step_ms"],
        "eager_tokens_per_s": e["tokens_per_s"],
        "eager_peak_memory_GB": e["peak_memory_GB"], "eager": e,
        "forward_ms": e["forward_ms"], "backward_ms": e["backward_ms"],
        "optimizer_ms": e["optimizer_ms"],
        "plain_backward_ms": e["plain_backward_ms"],
        "plain_backward_share": e["plain_backward_share"],
        "serve_after_train": {
            "captures": [served[1]["capture_ms"], served[2]["capture_ms"]],
            "allocated_GB": [served[1]["allocated"] / 1e9,
                             served[2]["allocated"] / 1e9],
            "allocated_rel_change": grew,
            "prefill_ms": [served[1]["prefill_ms"], served[2]["prefill_ms"]],
            "decode_ms": [served[1]["decode_ms"], served[2]["decode_ms"]],
            "tokens_equal_eager": True},
        "card": card_line()}
    torch.cuda.empty_cache()
    return steps, sizes, summary, loop_8f


def leaf_digests(tree) -> list:
    """Two int64 digests of every leaf's bits (a DTensor's local shard),
    in ``leaves`` order: the sum of its words, and their sum weighted by
    position (mod 65521, plus 1) -- equal bits give equal digests; the
    step count, a Python int, is kept as it is."""
    out = []
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        t = t.to_local() if sharding.is_dtensor(t) else t
        words = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        bits = t.detach().contiguous().view(words[t.element_size()]) \
            .flatten().to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
        del bits, w
    return out


def compression_check(grads) -> dict:
    """``quantize_int8`` then ``dequantize_int8`` of every gradient leaf
    (zero error feedback) on the card and on the CPU: the words, scales,
    dequantized values and new errors must agree bit for bit."""
    t0 = time.perf_counter()
    differ = []
    for name, g in _named(grads):
        z = torch.zeros_like(g, dtype=torch.float32)
        q, sc, err = compression.quantize_int8(g, z)
        deq = compression.dequantize_int8(q, sc)
        gc = g.cpu()
        qc, scc, errc = compression.quantize_int8(
            gc, torch.zeros_like(gc, dtype=torch.float32))
        deqc = compression.dequantize_int8(qc, scc)
        if not all(torch.equal(a.cpu(), b) for a, b in
                   ((q, qc), (sc, scc), (err, errc), (deq, deqc))):
            differ.append(name)
        del z, q, sc, err, deq, gc, qc, scc, errc, deqc
    if differ:
        raise SystemExit(f"train: int8 compression differs between the "
                         f"card and the CPU on {differ}")
    return {"leaves": len(_named(grads)), "bitwise_card_cpu": True,
            "seconds": time.perf_counter() - t0}


def mesh_train_phase(loop_8f: dict, device: str = "cuda") -> dict:
    """Phase 8g: phase 8f's ``train_loop`` again -- the same seed, batch,
    ``AdamWConfig`` and remat -- on a 1x1 mesh (``make_local_mesh()``
    over a one-rank NCCL group), where parameters, optimizer state and
    batch are DTensors placed by ``params_specs``, ``opt_specs`` and
    ``batch_specs``, twice:

      (a) ``eager=True``, 2 steps: the functional mesh step
          (``make_train_step``: DTensor's dispatch op by op, the model
          gathering each layer's parameters, DTensor's autograd reducing
          the gradients, ``adamw_update`` over DTensors, the batch placed
          by ``elastic.place`` every step) -- the route of ``--eager``
          and of every gloo mesh.  Its step 2 is the eager mesh baseline;
          the collectives are counted over both steps (``CommDebugMode``);
      (b) the compiled mesh step (``launch.mesh.compiled_route``), 3
          steps: step 1 runs the in-place step (``make_train_step_``,
          ``adamw_update_``) eagerly over static DTensor buffers on the
          graph's stream (the capture's warm-up), then one CUDA graph of
          the whole step is captured and steps 2-3 replay it, with no
          synchronising call in a replayed step's enqueue
          (``sync_debug="error"``).

    Gates: (a) "eager" and (b) "cuda graph" with two replays; at every
    step of both the loss, the global gradient norm and the digests of
    every parameter and optimizer leaf equal phase 8f's at that step bit
    for bit ((a) against 8f's ``eager=True`` loop, (b) against its
    compiled loop; 8f gates the two equal); every parameter leaf a
    DTensor with the placements of ``params_specs``; every step's
    launches and plain backwards, replays included, exactly
    ``expected_train_launches``.  Records each step's ms beside 8f's,
    (a)'s step-2 ms, (b)'s replayed step's ms, its capture ms, host µs a
    replay and peak memory, (a)'s peak and collectives, and the
    redistributions counted in each (a host counter: in (b) step 1 and
    the capture; a replay runs no Python)."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = dataclasses.replace(configs.get(HYMBA_ARCH), remat="dots")
    accum = elastic.replan_accum(TRAIN_BATCH, TRAIN_MICRO)
    want_launch, want_bwd = expected_train_launches(cfg, accum)
    mesh = mesh_mod.make_local_mesh()
    failures = []

    def run(eager: bool, steps: int, comm=None) -> dict:
        what = "eager mesh" if eager else "compiled mesh"
        rows = []

        def on_step(i, metrics):
            torch.cuda.synchronize()
            params = metrics["params"]
            rows.append({
                "step": i + 1, "ms": metrics["ms"],
                "launches": {k: _build.launch_counts()[k]
                             for k in MODEL_PATH_KERNELS},
                "plain_backwards": grad.backward_counts(),
                "digests": (metrics["loss"],
                            float(metrics["grad_norm"].full_tensor()),
                            leaf_digests(params),
                            leaf_digests(metrics["opt_state"]))})
            _build.reset_launch_counts()
            grad.reset_backward_counts()
            if i:
                return
            specs = sharding.sanitize_specs(
                params, sharding.params_specs(params, mesh), mesh)
            wrong = [name for (name, p), (_, spec) in
                     zip(_named(params), _named(specs))
                     if not sharding.is_dtensor(p) or tuple(p.placements)
                     != sharding.placements(spec, mesh)]
            if wrong:
                failures.append(f"{what}: parameters not placed by "
                                f"params_specs: {wrong[:5]}")

        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        grad.reset_backward_counts()
        sharding.reset_redistribution_counts()
        torch.cuda.reset_peak_memory_stats()
        trace = {}
        t0 = time.perf_counter()
        with comm if comm is not None else contextlib.nullcontext():
            train_loop(cfg, steps=steps, global_batch=TRAIN_BATCH,
                       seq_len=TRAIN_SEQ, micro_per_shard=TRAIN_MICRO,
                       opt_cfg=AdamWConfig(total_steps=TRAIN_STEPS,
                                           warmup_steps=1),
                       seed=SEED, device=device, on_step=on_step, mesh=mesh,
                       log_every=1, trace=trace, eager=eager,
                       sync_debug=None if eager else "error")
        wall_s = time.perf_counter() - t0
        want = loop_8f["eager_digests" if eager else "digests"]
        if len(rows) != steps:
            failures.append(f"{what}: {len(rows)} steps, not {steps}")
        for row, ref in zip(rows, want):
            got, i = row["digests"], row["step"]
            for j, key in enumerate(("loss", "gradient norm")):
                if got[j] != ref[j]:
                    failures.append(f"{what} step {i}: {key} {got[j]}, "
                                    f"phase 8f's {ref[j]}")
            for j, key in ((2, "parameter"), (3, "optimizer")):
                off = [n for n, (a, b) in enumerate(zip(got[j], ref[j]))
                       if a != b]
                if off or len(got[j]) != len(ref[j]):
                    failures.append(f"{what} step {i}: {key} leaves "
                                    f"{off[:8]} differ from phase 8f's")
            if row["launches"] != want_launch or \
                    row["plain_backwards"] != want_bwd:
                failures.append(f"{what} step {i}: launches "
                                f"{row['launches']} and plain backwards "
                                f"{row['plain_backwards']}, expected "
                                f"{want_launch} and {want_bwd}")
        out = {"rows": rows, "trace": trace, "wall_s": wall_s,
               "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
               "redistributions": sharding.redistribution_counts()}
        torch.cuda.empty_cache()
        return out

    comm = CommDebugMode()
    eager = run(True, 2, comm)
    compiled = run(False, TRAIN_STEPS)
    trace = compiled["trace"]
    if eager["trace"]["step"] != "eager":
        failures.append(f"eager mesh loop: step {eager['trace']['step']!r}")
    if trace["step"] != "cuda graph" or len(trace["replay_us"]) != \
            TRAIN_STEPS - 1:
        failures.append(f"compiled mesh loop: step {trace['step']!r} with "
                        f"{len(trace['replay_us'])} replays, expected a "
                        f"CUDA graph replayed {TRAIN_STEPS - 1} times")
    if failures:
        raise SystemExit("train on a mesh (hymba-1.5b): "
                         + "; ".join(failures))
    rows = compiled["rows"]
    ms = [r["ms"] for r in rows]
    eager_ms = [r["ms"] for r in eager["rows"]]
    step_ms = float(np.median(ms[1:]))
    return {"phase": "train on a mesh (hymba-1.5b)", "mesh": "1x1",
            "mesh_dims": list(mesh.mesh_dim_names), "backend": "nccl",
            "step": trace["step"],
            "route": "compiled: an NCCL mesh (launch.mesh.compiled_route); "
                     "eager=True for the eager mesh loop",
            "losses": [r["digests"][0] for r in rows],
            "grad_norms": [r["digests"][1] for r in rows],
            "bitwise_vs_8f_every_step": True, "leaves_compared":
            len(rows[0]["digests"][2]) + len(rows[0]["digests"][3]),
            "launches_per_step": rows[-1]["launches"],
            "plain_backwards_per_step": rows[-1]["plain_backwards"],
            "step_ms": step_ms, "step_ms_8f_compiled": loop_8f["step_ms"],
            "step_ms_rel_8f": step_ms / loop_8f["step_ms"],
            "eager_mesh_step_ms": eager_ms[1],
            "eager_mesh_steps_ms": eager_ms,
            "eager_mesh_steps_ms_8f_eager": loop_8f["eager_ms"][:2],
            "in_place_mesh_step1_ms": ms[0], "steps_ms": ms,
            "steps_ms_8f": loop_8f["ms"],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
            "capture_ms": trace["capture_ms"],
            "capture_ms_8f": loop_8f["capture_ms"],
            "replay_host_us": trace["replay_us"],
            "replay_host_us_8f": loop_8f["replay_host_us"],
            "peak_memory_GB": compiled["peak_memory_GB"],
            "peak_memory_GB_8f": loop_8f["peak_memory_GB"],
            "eager_mesh_peak_memory_GB": eager["peak_memory_GB"],
            "wall_s": compiled["wall_s"], "eager_mesh_wall_s": eager["wall_s"],
            "collectives_eager_mesh": {str(k): v for k, v in
                                       comm.get_comm_counts().items()},
            "collectives_total_eager_mesh": comm.get_total_counts(),
            "redistributions": compiled["redistributions"],
            "redistributions_eager_mesh": eager["redistributions"],
            "card": card_line()}


def mesh_serve_phase(cfg, weights: tuple, device: str = "cuda") -> dict:
    """Phase 8h: the granite serve (``MODEL_BATCH`` prompts of
    ``MODEL_PROMPT`` tokens, ``MODEL_GEN`` greedy tokens, the same
    weights) without a mesh (``eager=True``) and then under
    ``mesh_context(make_local_mesh())``, a one-rank NCCL group, where
    every MoE layer takes the mesh path (``local_map`` on the 1x1 mesh's
    shards, one all-reduce of y over ``model``): first eagerly
    (``eager=True``, after an uncounted warm-up), then twice through the
    compiled mesh step (``launch.mesh.compiled_route``): the first serve
    runs the prefill and step 0 eagerly and captures, the second replays
    both graphs.  Gates: the eager mesh serve's logits and tokens bit
    for bit the serve's without a mesh, its launches the same, its MoE
    mesh-path counter L x (1 + MODEL_GEN) (a host counter: it ticks on
    an eager step, so the compiled serves' would count their eager steps
    and captures; it is gated on the eager serve alone); both compiled
    serves "cuda graph", the first capturing and the second not, their
    logits and tokens bit for bit the eager mesh serve's, their launches
    after the prefill and in all (a replay's counted by its recording)
    and every decode step's launch sizes the eager mesh serve's, with no
    synchronising call in their replays (``sync_debug="error"``).
    Records the prefill and decode ms of all three (the compiled ones:
    the second, replayed serve), the capture ms, and the collectives and
    redistributions counted in the eager mesh serve."""
    from torch.distributed.tensor.debug import CommDebugMode
    params = weights[0]
    model = build(cfg)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (MODEL_BATCH, MODEL_PROMPT)).astype(np.int32)
    _build.reset_launch_counts()
    plain = {}
    tokens = serve_batch(cfg, params, prompts, gen_tokens=MODEL_GEN,
                         model=model, trace=plain, eager=True)
    plain_counts = {k: _build.launch_counts()[k] for k in MODEL_PATH_KERNELS}
    mesh = mesh_mod.make_local_mesh()
    with mesh_mod.mesh_context(mesh):   # warm-up, not counted
        serve_batch(cfg, params, prompts[:, :64], gen_tokens=2, model=model,
                    eager=True)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    moe_mod.reset_mesh_calls()
    sharding.reset_redistribution_counts()
    meshed = {}
    with mesh_mod.mesh_context(mesh), CommDebugMode() as comm:
        tokens_m = serve_batch(cfg, params, prompts, gen_tokens=MODEL_GEN,
                               model=model, trace=meshed, eager=True)
    counts = {k: _build.launch_counts()[k] for k in MODEL_PATH_KERNELS}
    calls, want_calls = moe_mod.mesh_calls(), cfg.n_layers * (1 + MODEL_GEN)
    redistributions = sharding.redistribution_counts()
    failures = []
    same = bool(np.array_equal(tokens, tokens_m)) and all(
        torch.equal(a, b) for a, b in zip(plain["logits"], meshed["logits"]))
    if not same:
        failures.append("logits or tokens differ from the serve without a "
                        "mesh")
    if calls != want_calls:
        failures.append(f"MoE mesh path ran {calls} times, expected "
                        f"{want_calls}")
    if counts != plain_counts:
        failures.append(f"launches {counts}, without a mesh {plain_counts}")
    compiled = []
    for _ in range(2):
        _build.reset_launch_counts()
        trace = {}
        with mesh_mod.mesh_context(mesh):
            toks = serve_batch(cfg, params, prompts, gen_tokens=MODEL_GEN,
                               model=model, trace=trace, sync_debug="error")
        torch.cuda.synchronize()
        compiled.append((toks, trace, {k: _build.launch_counts()[k]
                                       for k in MODEL_PATH_KERNELS}))
    pre_m = {k: meshed["launches_prefill"][k] for k in MODEL_PATH_KERNELS}
    for i, (toks, trace, total) in enumerate(compiled):
        what = ("first (capturing)", "second (replayed)")[i]
        if trace["step"] != "cuda graph" or (
                trace["capture_ms"] is None) != bool(i):
            failures.append(f"{what} compiled mesh serve: step "
                            f"{trace['step']!r}, capture_ms "
                            f"{trace['capture_ms']}")
        if not np.array_equal(toks, tokens_m) or not all(
                torch.equal(a, b)
                for a, b in zip(trace["logits"], meshed["logits"])):
            failures.append(f"{what} compiled mesh serve: logits or tokens "
                            "differ from the eager mesh serve")
        pre = {k: trace["launches_prefill"][k] for k in MODEL_PATH_KERNELS}
        if pre != pre_m or total != counts or \
                trace["decode_sizes"] != meshed["decode_sizes"]:
            failures.append(f"{what} compiled mesh serve: launches {pre} + "
                            f"{total}, eager mesh {pre_m} + {counts}, or "
                            "other decode sizes")
    if failures:
        raise SystemExit(f"serve on a mesh ({cfg.name}): "
                         + "; ".join(failures))
    first, second = compiled[0][1], compiled[1][1]
    release_graphs(model)
    return {"phase": f"serve on a mesh ({cfg.name})", "mesh": "1x1",
            "backend": "nccl", "step": second["step"],
            "route": "compiled: an NCCL mesh (launch.mesh.compiled_route); "
                     "eager=True for the eager mesh serve",
            "bitwise_vs_no_mesh": True,
            "compiled_bitwise_vs_eager_mesh": True, "moe_mesh_calls": calls,
            "launches": counts,
            "launches_per_decode_step": {
                k: (counts[k] - pre_m[k]) // MODEL_GEN
                for k in MODEL_PATH_KERNELS},
            "prefill_ms": second["prefill_ms"],
            "prefill_ms_eager_mesh": meshed["prefill_ms"],
            "prefill_ms_no_mesh": plain["prefill_ms"],
            "prefill_ms_first_compiled_eager": first["prefill_ms"],
            "decode_ms_per_token": float(np.median(second["decode_ms"])),
            "decode_ms_per_token_eager_mesh": float(
                np.median(meshed["decode_ms"])),
            "decode_ms_per_token_no_mesh": float(
                np.median(plain["decode_ms"])),
            "capture_ms": first["capture_ms"],
            "replay_host_us": float(np.median(second["replay_us"])),
            "collectives_eager_mesh": {str(k): v for k, v in
                                       comm.get_comm_counts().items()},
            "collectives_total_eager_mesh": comm.get_total_counts(),
            "redistributions_eager_mesh": redistributions,
            "card": card_line()}


def tp_collectives(cfg, gen: int, width: int = TP_MESH[1]) -> dict:
    """The all-reduces over ``model`` of one ``serve_batch`` on a mesh of
    a ``model`` axis of ``width`` and a data axis of 1: a pass (the
    prefill and each decode step) all-reduces, where ``model`` divides
    the vocabulary, the embedding's masked rows and the greedy pick's
    best logit and then its index (3; a whole vocabulary splits the
    head's tokens and gathers the logits instead); a layer's attention
    output (``wo``'s partial sums) -- in a decode step against a cache
    split by slots (``model`` not dividing the kv heads) also the scores'
    max and the sums of exponentials with the value partial sums (3) --
    its MLP output, and in a decode step its SSM output (``out_proj``'s
    partial sums).  yi-6b: (1 + gen)(2L + 3); hymba-1.5b: 2L + gen 5L."""
    L = cfg.n_layers
    fixed = 3 if cfg.vocab_size % width == 0 else 0
    mlp = 1 if cfg.d_ff else 0
    by_slots = cfg.n_kv_heads % width != 0
    prefill = fixed + L * (1 + mlp)
    decode = fixed + L * ((3 if by_slots else 1) + mlp
                          + (cfg.family in ("ssm", "hybrid")))
    return {"all_reduce": prefill + gen * decode}


def vocab_gathered(logits, mesh) -> torch.Tensor:
    """Logits split over ``model`` by vocabulary (or whole there, a
    vocabulary ``model`` does not divide), whole on the host: each rank's
    shard moved to the host and all-gathered there (gloo's functional
    all-gather of CUDA tensors kills the process in torch 2.11)."""
    import torch.distributed as dist
    local = logits.to_local().cpu()
    if not sharding.vocab_split(logits):
        return local
    parts = [torch.empty_like(local)
             for _ in range(mesh.size(sharding.model_dim(mesh)))]
    dist.all_gather(parts, local, group=mesh.get_group("model"))
    return torch.cat(parts, dim=-1)


class GlooCudaCollectives:
    """Phase 8i's transport for a run that gathers, a dispatch mode: its
    two processes share the card over ``gloo``, and the functional
    collectives named in ``ops`` (``GLOO_CUDA_HOST_OPS``: those that
    ``tools/torch_gloo_probe.py`` finds gloo runs wrong on CUDA tensors
    on the card -- its functional all-gather kills the process) run on
    host copies of their tensors, are waited for, and their results come
    back to the card (an in-place one's into its tensor): the same
    values, the same calls for ``CommDebugMode`` (entered inside this
    mode) to count.  Every other op, the all-reduces among them, runs as
    it is, the port waiting for it as over NCCL (the CPU gloo tests fail
    on a functional collective left unwaited).  A transport of this
    two-process emulation only."""

    def __init__(self, ops):
        self.ops = tuple(ops)

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        ops = self.ops

        def host(a):
            if isinstance(a, torch.Tensor) and a.is_cuda:
                return a.cpu()
            if isinstance(a, (list, tuple)):
                return type(a)(host(x) for x in a)
            return a

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.__name__.split(".")[0]
                cuda = [a for a in args if isinstance(a, torch.Tensor)
                        and a.is_cuda] + [x for a in args
                                          if isinstance(a, (list, tuple))
                                          for x in a
                                          if isinstance(x, torch.Tensor)
                                          and x.is_cuda]
                if any(t.__name__ == "DTensor" for t in types):
                    # DTensor's dispatch runs outside this handler, so
                    # the collectives it issues come back through here
                    return NotImplemented
                if func.namespace not in ("_c10d_functional", "_dtensor") \
                        or name not in ops or not cuda:
                    return func(*args, **kwargs)
                dev = cuda[0].device
                out = func(*host(args), **host(kwargs))
                wait = torch.ops._c10d_functional.wait_tensor
                if isinstance(out, (list, tuple)):
                    return type(out)(wait(o).to(dev) for o in out)
                out = wait(out).to(dev)
                if name.endswith("_"):          # in place: into its tensor
                    return args[0].copy_(out)
                return out
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def tp_rank(rank: int, world: int, store: str, cfg, prompt: int, gen: int,
            device: str, host_ops: tuple, out) -> None:
    """One rank of phase 8i: join the gloo group, place ``cfg``'s random
    weights (seed SEED) on the (1, 2) mesh by ``params_specs``, serve
    twice through ``serve_batch`` under ``mesh_context`` (the launches,
    collectives, tokens and logits of each); rank 0 then serves the same
    weights without a mesh (timed) and teacher-forces them with the mesh
    serve's tokens.  Puts (rank, True, result) or (rank, False, the
    traceback) on ``out``."""
    import datetime
    import faulthandler
    import traceback

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    os.makedirs(os.path.dirname(TP_LOG), exist_ok=True)
    log = open(TP_LOG.format(rank=rank, arch=cfg.name), "w")
    # a rank that hangs writes every thread's stack to its log
    faulthandler.enable(file=log)
    faulthandler.dump_traceback_later(TP_TIMEOUT - 60, file=log)
    t0 = time.perf_counter()

    def note(msg: str) -> None:
        log.write(f"{time.perf_counter() - t0:9.3f} s  {msg}\n")
        log.flush()
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
        note("group joined")
        mesh = mesh_mod.make_mesh(TP_MESH, ("data", "model"), devices=device)
        note(f"mesh {mesh}")
        model = build(cfg)
        full = model.init(torch.Generator(device=device).manual_seed(SEED))
        params = elastic.place(full, mesh, sharding.params_specs(full, mesh))
        if rank:
            del full
        note("weights placed")
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(0, cfg.vocab_size,
                               (MODEL_BATCH, prompt)).astype(np.int32)
        transport = GlooCudaCollectives(host_ops) \
            if device == "cuda" and host_ops else contextlib.nullcontext()
        with transport, mesh_mod.mesh_context(mesh):   # warm-up
            serve_batch(cfg, params, prompts[:, :64], gen_tokens=2,
                        model=model)
        note("warm-up served")
        runs = []
        for _ in range(2):
            _build.reset_launch_counts()
            trace = {}
            with transport, mesh_mod.mesh_context(mesh), \
                    CommDebugMode() as comm:
                tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                                     model=model, trace=trace)
            total = _build.launch_counts()
            pre = trace["launches_prefill"]
            with transport:
                logits = [vocab_gathered(lg, mesh) for lg in
                          trace["logits"]]
            runs.append({
                "tokens": tokens,
                "logits": logits,
                "launches_prefill": {k: pre[k] for k in MODEL_PATH_KERNELS},
                "launches_decode": {k: total[k] - pre[k]
                                    for k in MODEL_PATH_KERNELS},
                "sizes": _build.launch_sizes(),
                "collectives": {str(k).split(".")[-1]: v for k, v in
                                comm.get_comm_counts().items()},
                "prefill_ms": trace["prefill_ms"],
                "decode_ms": trace["decode_ms"], "step": trace["step"]})
            note(f"served: prefill {trace['prefill_ms']} ms")
        first, second = runs
        result = {k: first[k] for k in (
            "tokens", "launches_prefill", "launches_decode", "sizes",
            "collectives", "prefill_ms", "decode_ms", "step")}
        result["repeat_bitwise"] = bool(np.array_equal(
            first["tokens"], second["tokens"])) and all(
            torch.equal(a, b) for a, b in zip(first["logits"],
                                              second["logits"]))
        result["repeat_collectives"] = second["collectives"]
        result["local_params"] = sum(
            p.to_local().numel() for p in leaves(params))
        if rank == 0:
            plain = {}
            result["plain_tokens"] = serve_batch(
                cfg, full, prompts, gen_tokens=gen, model=model, trace=plain,
                eager=True)
            result["plain_prefill_ms"] = plain["prefill_ms"]
            result["plain_decode_ms"] = plain["decode_ms"]
            ref, _ = teacher_forced(model, full, prompts, first["tokens"],
                                    device)
            # numpy across the queue: a tensor's shared memory would go
            # with the process
            result["logits"] = [lg.numpy() for lg in first["logits"]]
            result["ref_logits"] = [lg.cpu().numpy() for lg in ref]
            if device == "cuda":
                result["peak_memory_GB"] = \
                    torch.cuda.max_memory_allocated() / 1e9
        note("done")
        dist.barrier()
        out.put((rank, True, result))
    except BaseException:
        note(traceback.format_exc())
        out.put((rank, False, traceback.format_exc()))
    finally:
        faulthandler.cancel_dump_traceback_later()
        if dist.is_initialized():
            dist.destroy_process_group()
        log.close()


def tp_serve_phase(cfg=None, *, prompt: int = MODEL_PROMPT,
                   gen: int = MODEL_GEN, device: str = "cuda",
                   host_ops: tuple = ()) -> tuple:
    """Phase 8i: ``cfg`` (yi-6b at full width, random weights from seed
    SEED) served on a (1, 2) mesh of two processes sharing the card, one
    gloo group, its ``model`` axis splitting the attention heads (32/4 ->
    16/2 a rank), the SwiGLU hidden dim (11 008 -> 5 504) and the
    vocabulary (64 000 -> 32 000): ``MODEL_BATCH`` prompts of ``prompt``
    tokens, ``gen`` greedy tokens through ``serve_batch``.  Gates against
    the same weights served without a mesh on the card (rank 0,
    teacher-forced with the mesh serve's tokens): the logits within
    ``logits_rtol(cfg)`` and the tokens equal but at near-ties
    (``logits_gates``); two mesh serves bit for bit equal on each rank;
    each rank's launches exactly ``expected_launches``; each rank's
    collectives (``CommDebugMode``) exactly ``tp_collectives``.  Records
    prefill and decode ms beside the serve without a mesh.  ``host_ops``:
    the functional collectives ``GlooCudaCollectives`` moves to the host
    on the card (none: no transport).  Returns (rank 0's launches, the
    kernel sizes either rank launched, the summary)."""
    import tempfile

    import torch.multiprocessing as mp
    cfg = cfg or configs.get(TP_ARCH)
    world = TP_MESH[0] * TP_MESH[1]
    if device == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=tp_rank, args=(
            r, world, os.path.join(tmp, "store"), cfg, prompt, gen, device,
            host_ops, q)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + TP_TIMEOUT
        try:
            while len(results) + len(errors) < world:
                try:
                    rank, ok, value = q.get(timeout=5)
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in results]
                    if gone and q.empty():   # died without a word
                        errors += [f"rank {r} exited with code "
                                   f"{procs[r].exitcode}, no result"
                                   for r in gone]
                    elif time.perf_counter() > deadline:
                        errors.append(f"no result within {TP_TIMEOUT} s")
                    if gone or time.perf_counter() > deadline:
                        break
                    continue
                (results.__setitem__(rank, value) if ok
                 else errors.append(f"rank {rank}:\n{value}"))
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    name = f"serve on a {TP_MESH[0]}x{TP_MESH[1]} mesh ({cfg.name})"
    if errors:
        logs = "".join(f"\nrank {r}'s log:\n" + open(
            TP_LOG.format(rank=r, arch=cfg.name)).read()[-3000:]
            for r in range(world)
            if os.path.exists(TP_LOG.format(rank=r, arch=cfg.name)))
        raise SystemExit(f"{name}: " + "\n".join(errors) + logs)
    wall_s = time.perf_counter() - t0
    r0 = results[0]
    failures = []
    rtol = logits_rtol(cfg)
    logits = [torch.from_numpy(lg) for lg in r0["logits"]]
    rel_rms, max_abs, agree, ties, differ = logits_gates(
        logits, [torch.from_numpy(lg) for lg in r0["ref_logits"]], rtol,
        "serve without a mesh", failures)
    want_pre, want_dec = expected_launches(cfg, gen)
    want_comm = tp_collectives(cfg, gen)
    width = TP_MESH[1]
    layout = sharding.attn_layout(cfg, width)
    # where every split is Megatron's, the all-reduces are all there is;
    # otherwise the gathers of the other layouts and of DTensor's
    # sequence split of the SSM branch are recorded beside them
    only_reduces = layout == "heads" and cfg.vocab_size % width == 0
    kernels = path_kernels(cfg)
    for rank, r in sorted(results.items()):
        if not r["repeat_bitwise"]:
            failures.append(f"rank {rank}: two mesh serves differ")
        if r["step"] != "eager":    # gloo's route (launch.mesh)
            failures.append(f"rank {rank}: a gloo mesh serve ran "
                            f"{r['step']!r}, not 'eager'")
        for k in kernels:
            if (r["launches_prefill"][k], r["launches_decode"][k]) != (
                    want_pre[k], want_dec[k]):
                failures.append(
                    f"rank {rank}: {k} launched {r['launches_prefill'][k]} "
                    f"+ {r['launches_decode'][k]}, expected {want_pre[k]} + "
                    f"{want_dec[k]}")
        for comm in (r["collectives"], r["repeat_collectives"]):
            got = {k: v for k, v in comm.items() if v}
            if got.get("all_reduce") != want_comm["all_reduce"] or (
                    only_reduces and got != want_comm):
                failures.append(f"rank {rank}: collectives {got}, "
                                f"expected {want_comm}" + (
                                    "" if only_reduces else " all-reduces"))
    if r0["tokens"].shape != (MODEL_BATCH, gen) or not all(
            lg.shape == (MODEL_BATCH, cfg.vocab_size)
            and bool(torch.isfinite(lg).all()) for lg in logits):
        failures.append("bad tokens or non-finite logits")
    owners = None
    if cfg.n_kv_heads % width:      # the cache split by slots: the ranks
        slots = prompt + gen        # whose slots the decode steps wrote
        slots = cfg.window if cfg.window and cfg.window < slots else slots
        owners = sorted({p % slots // -(-slots // width)
                         for p in range(prompt, prompt + gen)})
        if owners == [0]:
            failures.append("the decode wrote no slot past rank 0's")
    if failures:
        raise SystemExit(f"{name}: " + "; ".join(failures))
    sizes = {k: set().union(*(r["sizes"][k] for r in results.values()))
             for k in MODEL_PATH_KERNELS}
    summary = {
        "phase": name, "arch": cfg.name, "mesh": "x".join(map(str, TP_MESH)),
        "ranks": world, "backend": "gloo", "device": device,
        "step": r0["step"],
        "route": "eager: gloo's collectives run on the host, where no CUDA "
                 "graph sees them (launch.mesh.compiled_route)",
        "attention_layout": layout,
        "heads_per_rank": {"heads": [cfg.n_heads // width,
                                     cfg.n_kv_heads // width],
                           "groups": [cfg.n_heads // width, 1],
                           "sequence": [cfg.n_heads, cfg.n_kv_heads]}[layout],
        "positions_per_rank": -(-prompt // width) if layout == "sequence"
        else prompt,
        "cache_split": "kv heads" if cfg.n_kv_heads % width == 0
        else "slots", "decode_slot_owners": owners,
        "d_ff_per_rank": cfg.d_ff // width,
        "vocab_per_rank": cfg.vocab_size // width
        if cfg.vocab_size % width == 0 else
        f"{cfg.vocab_size} (whole; the head splits the tokens)",
        "local_params": [results[r]["local_params"] for r in sorted(results)],
        "batch": MODEL_BATCH, "prompt": prompt, "gen_tokens": gen,
        "prefill_ms": r0["prefill_ms"],
        "prefill_ms_no_mesh": r0["plain_prefill_ms"],
        "decode_ms_per_token": float(np.median(r0["decode_ms"])),
        "decode_ms_per_token_no_mesh": float(np.median(
            r0["plain_decode_ms"])),
        "rank1_prefill_ms": results[1]["prefill_ms"],
        "rank1_decode_ms_per_token": float(np.median(
            results[1]["decode_ms"])),
        "logits_rel_rms_vs_no_mesh": rel_rms,
        "logits_rel_rms_max": max(rel_rms), "logits_rtol": rtol,
        "logits_max_abs_diff": max_abs, "greedy_agreement": agree,
        "tokens_differing": differ, "near_tie_rows": sum(ties),
        "tokens_equal_free_running_no_mesh": bool(np.array_equal(
            r0["tokens"], r0["plain_tokens"])),
        "tokens_first_row": r0["tokens"][0].tolist(),
        "repeat_bitwise": True,
        "launches_prefill": r0["launches_prefill"],
        "launches_decode": r0["launches_decode"],
        "collectives": r0["collectives"], "collectives_expected": want_comm,
        "peak_memory_GB_rank0": r0.get("peak_memory_GB"),
        "wall_s": wall_s}
    if device == "cuda":
        summary["card"] = card_line()
    launches = {k: r0["launches_prefill"][k] + r0["launches_decode"][k]
                for k in MODEL_PATH_KERNELS}
    return launches, sizes, summary


def plain_backward_case(name: str, shape: tuple, dtype: torch.dtype,
                        rng: np.random.Generator, *, window=None) -> dict:
    """The plain vjp ``kernels.grad`` runs for ``name`` at a training
    shape: the op called on inputs that require grad (its ``grad_fn``
    must be the kernel's Function), then one backward of that node timed
    (``time_ms``: the plain version recomputed and differentiated)."""
    dev = torch.device("cuda")

    def randn(*s, dt=dtype, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(dev) * scale).to(dt).requires_grad_(True)
    if name == "vecadd_2d":
        xs = [randn(*shape), randn(*shape)]
        out, fn = vecadd_op(*xs), "VecAdd"
    elif name == "rmsnorm_2d":
        xs = [randn(*shape, scale=3.0), randn(shape[1], dt=torch.float32)]
        out, fn = rmsnorm_op(*xs, eps=1e-5), "RMSNorm"
    elif name == "rope_3d":
        bh, s, d = shape
        cos, sin = rope_ref.rope_tables(torch.arange(s, device=dev), d)
        xs = [randn(bh, s, d)]
        out, fn = rope_op(xs[0], cos, sin), "Rope"
    elif name == "flash_attention_3d":
        bhq, bhkv, s, d = shape
        b = TRAIN_MICRO
        xs = [randn(b, bhq // b, s, d), randn(b, bhkv // b, s, d),
              randn(b, bhkv // b, s, d)]
        out, fn = attention_op(*xs, window=window), "FlashAttention"
    else:
        bc, lc, h, p, n = shape
        cum = torch.cumsum(-torch.from_numpy(rng.uniform(
            0.001, 0.1, (bc, lc, h)).astype(np.float32)).to(dev), dim=1)
        xs = [randn(bc, lc, h, p), randn(bc, lc, n), randn(bc, lc, n),
              cum.requires_grad_(True)]
        out, fn = ssd_op(*xs), "SSDIntra"
    outs = out if isinstance(out, tuple) else (out,)
    if type(outs[0].grad_fn).__name__ != fn + "Backward":
        raise SystemExit(f"{name}: the op's grad_fn is "
                         f"{type(outs[0].grad_fn).__name__}, not {fn}'s")
    cots = [torch.randn_like(o) for o in outs]
    ms, host_us = time_ms(lambda: torch.autograd.grad(outs, xs, cots,
                                                      retain_graph=True))
    row = {"kernel": name, "size": "train plain backward",
           "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "grad_fn": fn + "Backward", "plain_backward_ms": ms,
           "plain_backward_host_us": host_us}
    emit(row)
    return row


# -- per-kernel checks and timings ---------------------------------------------

_L2_FLUSH = None


def time_ms(fn) -> tuple[float, float]:
    """(device ms, host us) of ``fn``: the median CUDA-event time over REPS
    runs, L2 flushed before each run (a 128 MB write) and the device
    spinning while the host enqueues, and the median host time of one
    call (enqueueing only: the device is still spinning); after one warm
    run."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    times, host = [], []
    for _ in range(REPS):
        _L2_FLUSH.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), float(np.median(host)) * 1e6


def off_alignment(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary, a view into a buffer one element longer: the
    scalar kernels' case of ``rmsnorm_2d`` and ``vecadd_2d``."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise SystemExit("off_alignment: the view is 16-byte aligned")
    return view


def copy_ms(nbytes: int, dev: torch.device) -> float:
    """The floor of one pass over ``nbytes`` as ``time_ms`` times it: a
    device copy that reads nbytes / 2 and writes nbytes / 2."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src))[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality of two tensors on the card (-0.0 != 0.0)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def projective_case(shape: tuple, rng: np.random.Generator, dev,
                    misaligned: bool = False):
    """(run, plain, library, bytes, ops) for a projective kernel at
    ``shape``: a workload-style homography and cull bounds per chain;
    ``misaligned`` puts the points one element off 16-byte alignment."""
    d = shape[-1]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    if misaligned:
        x = off_alignment(x)
    hs = [workload.random_projective(rng, d) for _ in range(lead[0] if lead else 1)]
    h = torch.from_numpy(np.stack(hs) if batched else hs[0]).to(dev)
    lo = torch.from_numpy(rng.uniform(-6, -3, lead + (d,)).astype(np.float32)).to(dev)
    hi = torch.from_numpy(rng.uniform(3, 6, lead + (d,)).astype(np.float32)).to(dev)
    if batched:
        def run():
            return proj_k.chain_project_batch_2d(x, h, lo, hi)

        def plain():
            return proj_ref.chain_project_batch(x, h, lo, hi)

        def lib():
            qh = torch.baddbmm(h[:, d:d + 1], x, h[:, :d])
            w = qh[..., d]
            ok = w > 0
            v = qh[..., :d] / torch.where(ok, w, 1.0)[..., None]
            return v, ok & ((v >= lo[:, None]) & (v <= hi[:, None])).all(-1)
    else:
        def run():
            out, mask = proj_k.chain_project_1d(x.reshape(-1), h, lo, hi, d=d)
            return out.reshape(shape), mask

        def plain():
            return proj_ref.chain_project(x, h, lo, hi)

        def lib():
            qh = torch.addmm(h[d], x, h[:d])
            w = qh[:, d]
            ok = w > 0
            v = qh[:, :d] / torch.where(ok, w, 1.0)[:, None]
            return v, ok & ((v >= lo) & (v <= hi)).all(-1)
    n_points = x.numel() // d
    n_chains = lead[0] if lead else 1
    # the bytes the kernel really moves: points in and out, one mask byte
    # per point, the parameters once
    nbytes = 8 * x.numel() + n_points \
        + 4 * n_chains * opcount.chain_param_words(d, "projective")
    ops = (2 * d * (d + 1) + 3 * d) * n_points
    return run, plain, lib, nbytes, ops


def kernel_case(name: str, shape: tuple, rng: np.random.Generator,
                size: str, *, check_only: bool = False,
                misaligned: bool = False) -> dict:
    """Check one kernel at one shape, (N, d) flat or (B, L, d), then time
    it unless ``check_only``; ``size`` says which of the path's sizes the
    shape is.  A row bound by bytes also times a device copy of as many
    bytes (``copy_ms``).  ``misaligned`` puts the points one element off
    16-byte alignment."""
    d = shape[-1]
    kind = KERNELS[name][2]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()
    dev = torch.device("cuda")
    library = "composite" if kind == "projective" \
        else "addcmul" if kind == "diag" else "baddbmm"
    if kind == "projective":
        run, plain, lib, nbytes, ops = projective_case(shape, rng, dev,
                                                       misaligned)
    else:
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
        if misaligned:
            x = off_alignment(x)
        t = torch.from_numpy(rng.uniform(-3, 3, lead + (d,)).astype(np.float32)).to(dev)
        if kind == "diag":
            p = torch.from_numpy(rng.uniform(0.2, 2, lead + (d,)).astype(np.float32)).to(dev)
            if batched:
                run = lambda: diag_k.chain_diag_batch_2d(x, p, t)   # noqa: E731
                plain = lambda: diag_ref.chain_diag_batch(x, p, t)  # noqa: E731
                lib = lambda: torch.addcmul(t[:, None], x, p[:, None])  # noqa: E731
            else:
                run = lambda: diag_k.chain_diag_1d(x.reshape(-1), p, t, d=d).reshape(shape)  # noqa: E731
                plain = lambda: diag_ref.chain_diag(x, p, t)  # noqa: E731
                lib = lambda: torch.addcmul(t, x, p)  # noqa: E731
            ops = 2 * x.numel()
        else:
            p = torch.from_numpy(rng.uniform(-1, 1, lead + (d, d)).astype(np.float32)).to(dev)
            if batched:
                run = lambda: matrix_k.chain_matrix_batch_2d(x, p, t)   # noqa: E731
                plain = lambda: matrix_ref.chain_matrix_batch(x, p, t)  # noqa: E731
                lib = lambda: torch.baddbmm(t[:, None], x, p)  # noqa: E731
            else:
                run = lambda: matrix_k.chain_matrix_1d(x.reshape(-1), p, t, d=d).reshape(shape)  # noqa: E731
                plain = lambda: matrix_ref.chain_matrix(x, p, t)  # noqa: E731
                lib = lambda: torch.baddbmm(t.view(1, 1, d), x.view(1, -1, d), p.view(1, d, d)).view(shape)  # noqa: E731
            ops = 2 * d * x.numel()
        n_points = x.numel() // d
        nbytes = opcount.packed_chain_bytes(shape[0], shape[1], d, kind=kind) \
            if batched else opcount.fused_chain_bytes(n_points, d, kind=kind)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if kind == "projective":
        (got, got_mask), (want, want_mask) = got, want
        if not same_bits(got_mask, want_mask):
            raise SystemExit(f"{name} {shape}: kernel mask != plain version")
    if not same_bits(got, want):
        raise SystemExit(f"{name} {shape}: kernel != plain version")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if check_only:
        row = {"kernel": name, "size": size, "shape": list(shape),
               "check": "equal", "misaligned": misaligned,
               "max_abs_err": err}
        emit(row)
        return row
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    row = {"kernel": name, "size": size, "shape": list(shape), "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes,
           "GB/s": nbytes / ms / 1e6, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms,
           # no single PyTorch call computes project + divide + cull: the
           # composite's time is kept apart from library_ms
           "library_ms": None if library == "composite" else lib_ms,
           "composite_ms": lib_ms if library == "composite" else None,
           "library": library,
           "copy_ms": copy_ms(nbytes, dev) if byte_ms >= op_ms else None,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
    if kind == "projective":
        n_points = math.prod(shape[:-1])
        row["opcount_bytes"] = opcount.packed_chain_bytes(
            shape[0], shape[1], d, kind=kind) if batched \
            else opcount.fused_chain_bytes(n_points, d, kind=kind)
    emit(row)
    return row


def q_case(shape: tuple, kind: str, rng: np.random.Generator, dev,
           misaligned: bool = False):
    """(run, plain, composite, oracle, bytes, ops) of an int16 kernel at
    ``shape`` on full-range words, each a function of n_frac (the oracle:
    the numpy Q oracle, request by request); ``misaligned`` puts the
    points one element off 16-byte alignment.  The composite (no
    single PyTorch call requantises a Qm.n chain, and ``torch.matmul`` has
    no integer path on CUDA) is a float64 ``addcmul``/``addmm``/
    ``baddbmm`` -- exact: |acc| < 2**32 -- then an int64 rounding shift
    and the narrowing to int16."""
    d = shape[-1]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()

    def words(s):
        return torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, s)
                                .astype(np.int16)).to(dev)

    x = words(shape)
    if misaligned:
        x = off_alignment(x)
    p = words(lead + ((d,) if kind == "diag" else (d, d)))
    t = words(lead + (d,))
    n_points = x.numel() // d

    def requant(acc, n):
        acc = acc.to(torch.int64)
        return ((acc + (1 << (n - 1))) >> n if n else acc).to(torch.int16)

    if kind == "diag":
        wrap = q_k.chain_diag_batch_2d_q if batched else q_k.chain_diag_1d_q
        plain_fn = q_ref.chain_diag_batch_q if batched else q_ref.chain_diag_q
        tb, pb = (t[:, None], p[:, None]) if batched else (t, p)

        def lib(n):
            return requant(torch.addcmul(tb.double() * (1 << n), x.double(),
                                         pb.double()), n)
        ops = 5 * x.numel()           # multiply, shift t, two adds, shift
    else:
        wrap = q_k.chain_matrix_batch_2d_q if batched else q_k.chain_matrix_1d_q
        plain_fn = q_ref.chain_matrix_batch_q if batched \
            else q_ref.chain_matrix_q

        def lib(n):
            if batched:
                acc = torch.baddbmm(t.double()[:, None] * (1 << n), x.double(),
                                    p.double())
            else:
                acc = torch.addmm(t.double() * (1 << n), x.double(), p.double())
            return requant(acc, n)
        ops = (2 * d + 3) * x.numel()  # d multiply-adds, shift t, round, shift

    def run(n):
        if batched:
            return wrap(x, p, t, n_frac=n)
        return wrap(x.reshape(-1), p, t, d=d, n_frac=n).reshape(shape)

    def plain(n):
        return plain_fn(x, p, t, n)

    def oracle(n):
        fn = q_ref.np_chain_diag_q if kind == "diag" \
            else q_ref.np_chain_matrix_q
        xs, ps, ts = (v.cpu().numpy() for v in (x, p, t))
        if not batched:
            return torch.from_numpy(fn(xs, ps, ts, n))
        return torch.from_numpy(np.stack([fn(xs[i], ps[i], ts[i], n)
                                          for i in range(shape[0])]))

    nbytes = opcount.packed_chain_bytes(shape[0], shape[1], d, itemsize=2,
                                        kind=kind) if batched \
        else opcount.fused_chain_bytes(n_points, d, itemsize=2, kind=kind)
    return run, plain, lib, oracle, nbytes, ops


def kernel_case_q(name: str, shape: tuple, rng: np.random.Generator,
                  size: str, *, check_only: bool = False,
                  misaligned: bool = False) -> dict:
    """Check one int16 kernel at one shape against its plain version and
    the numpy Q oracle at every n_frac of Q_FRACS, on full-range words
    (``misaligned``: the points one element off 16-byte alignment); time
    it at q8.7's unless ``check_only``."""
    d = shape[-1]
    run, plain, lib, oracle, nbytes, ops = q_case(
        shape, KERNELS[name][2], rng, torch.device("cuda"), misaligned)
    composite_equal = True
    for n in Q_FRACS:
        got, want, comp = run(n), plain(n), lib(n)
        torch.cuda.synchronize()
        if got.dtype != torch.int16 or not same_bits(got, want):
            raise SystemExit(f"{name} {shape} n_frac={n}: kernel != plain "
                             "version")
        # the redesigned kernels also against the numpy Q oracle
        if name in Q_BATCH.values() and not same_bits(got.cpu(), oracle(n)):
            raise SystemExit(f"{name} {shape} n_frac={n}: kernel != numpy "
                             "Q oracle")
        composite_equal &= same_bits(got, comp)
    err = float((got.int() - want.int()).abs().max()) if got.numel() else 0.0
    if check_only:
        row = {"kernel": name, "size": size, "shape": list(shape), "d": d,
               "dtype": "int16", "n_frac_checked": list(Q_FRACS),
               "check": "equal", "misaligned": misaligned,
               "max_abs_err": err}
        emit(row)
        return row
    n = Q8_7.n
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(lambda: run(n)), time_ms(lambda: plain(n)), \
        time_ms(lambda: lib(n))
    row = {"kernel": name, "size": size, "shape": list(shape), "d": d,
           "dtype": "int16", "n_frac_checked": list(Q_FRACS),
           "timed_n_frac": n, "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes,
           "GB/s": nbytes / ms / 1e6, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms, "library_ms": None, "composite_ms": lib_ms,
           "library": "composite", "composite_equal": composite_equal,
           "copy_ms": copy_ms(nbytes, torch.device("cuda"))
           if byte_ms >= op_ms else None,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
    emit(row)
    return row


def eager_case(name: str, shape: tuple, dtype: torch.dtype,
               rng: np.random.Generator, size: str, *,
               check_only: bool = False, misaligned: tuple = ()) -> dict:
    """Check one eager kernel against its plain version, then time it
    unless ``check_only``: ``affine_2d``/``vecadd_2d`` at (M, N),
    ``matmul_2d`` at (M, K, N), inputs and output of ``dtype``; the
    yardstick is one PyTorch call (``addcmul`` / ``add`` / ``matmul``,
    TF32 off), and for a row bound by bytes also a device copy that
    reads and writes as many bytes (``copy_ms``).  Bit for bit, except
    ``matmul_2d``'s tensor-core regime (bfloat16, K > 8 or N > 8), which
    is held within ``bounds.matmul_bound``; the row's ``check`` says
    which.  ``misaligned`` names the operands (``x``, ``z`` of
    ``vecadd_2d``; ``x``, ``s``, ``t`` of ``affine_2d``) put one element
    off 16-byte alignment."""
    dev = torch.device("cuda")

    def randn(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) \
            .to(dev).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    peak = BF16_OPS_PER_S if (dtype == torch.bfloat16
                              and name == "matmul_2d") else FP32_OPS_PER_S
    if name == "affine_2d":
        m, n = shape
        x, s, t = randn(m, n), randn(n), randn(n)
        x, s, t = (off_alignment(a) if k in misaligned else a
                   for k, a in (("x", x), ("s", s), ("t", t)))
        run = lambda: diag_k.affine_2d(x, s, t)   # noqa: E731
        plain = lambda: diag_ref.affine(x, s, t)  # noqa: E731
        lib, library = (lambda: torch.addcmul(t, x, s)), "addcmul"
        nbytes, ops = (2 * m * n + 2 * n) * item, 2 * m * n
    elif name == "vecadd_2d":
        m, n = shape
        x, z = randn(m, n), randn(m, n)
        x, z = (off_alignment(a) if k in misaligned else a
                for k, a in (("x", x), ("z", z)))
        run = lambda: diag_k.vecadd_2d(x, z)   # noqa: E731
        plain = lambda: diag_ref.vecadd(x, z)  # noqa: E731
        lib, library = (lambda: torch.add(x, z)), "add"
        nbytes, ops = 3 * m * n * item, m * n
    else:
        m, k, n = shape
        x, y = randn(m, k), randn(k, n)
        run = lambda: matrix_k.matmul_2d(x, y)   # noqa: E731
        plain = lambda: matrix_ref.matmul(x, y)  # noqa: E731
        lib, library = (lambda: torch.matmul(x, y)), "matmul"
        nbytes, ops = (m * k + k * n + m * n) * item, 2 * m * k * n
    got, want = run(), plain()
    torch.cuda.synchronize()
    if name == "matmul_2d" and matrix_k.tensor_cores(dtype, *shape[1:]):
        check = "within_bound"
        if not bool(((got.float() - want.float()).abs()
                     <= bounds.matmul_bound(x, y, want)).all()):
            raise SystemExit(f"{name} {shape} {dtype}: kernel outside "
                             f"matmul_bound of the plain version")
    else:
        check = "equal"
        if not same_bits(got, want):
            raise SystemExit(f"{name} {shape} {dtype}: kernel != plain "
                             f"version")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if check_only:
        row = {"kernel": name, "size": size, "shape": list(shape),
               "dtype": str(dtype).removeprefix("torch."), "check": check,
               "misaligned": list(misaligned), "max_abs_err": err}
        emit(row)
        return row
    lib_err = float((got.float() - lib().float()).abs().max())
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    row = {"kernel": name, "size": size, "shape": list(shape),
           "dtype": str(dtype).removeprefix("torch."), "check": check,
           "max_abs_err": err, "ms": ms, "bytes": nbytes, "ops": ops,
           "GB/s": nbytes / ms / 1e6, "TFLOP/s": ops / ms / 1e9,
           "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms, "library_ms": lib_ms, "composite_ms": None,
           "library": library, "library_max_abs_diff": lib_err,
           "copy_ms": copy_ms(nbytes, dev) if byte_ms >= op_ms else None,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # the baddbmm yardstick
    card = card_line()
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": _build.sources()})
    # the redesigned kernels' instances as ptxas built them, and the
    # instructions their designs rest on in the SASS
    for source in SASS_REQUIRED:
        sass = sass_counts(source)
        emit({"phase": "ptxas", "source": source, "sass": sass,
              "instances": _build.resource_usage(source)})
        if sass_missing(sass):
            raise SystemExit(f"{source}: the SASS of {sass_missing(sass)} "
                             f"lacks one of {SASS_REQUIRED[source]}")

    _, summary, largest_affine, sizes_affine = serve_phase(
        "serve", workload.AFFINE_TEMPLATES)
    emit(summary)
    counts, summary, largest, sizes = serve_phase(
        "serve (mixed)", workload.TEMPLATES)
    emit(summary)
    require_launched(counts, FLOAT_KERNELS, "mixed serve")
    graphics_counts, summary = graphics_phase()
    emit(summary)
    q_counts, summary, largest_q, sizes_q = q_mixed_phase()
    emit(summary)
    emit(emulator_phase())
    eager_counts, summary = primitives_phase()
    emit(summary)
    require_launched(eager_counts, EAGER_KERNELS, "primitives")
    scene_counts, summary = scene_phase()
    emit(summary)
    hymba_counts, hymba_sizes, summary = model_phase(configs.get(HYMBA_ARCH))
    emit(summary)
    gcfg = configs.get(GRANITE_ARCH)
    gweights = init_params(gcfg)
    granite_counts, granite_sizes, summary = model_phase(
        gcfg, weights=gweights)
    emit(summary)
    emit(mesh_serve_phase(gcfg, gweights))
    # the same weights with an int8 KV cache (linear: granite has no window)
    int8_counts, int8_sizes, summary = model_phase(
        dataclasses.replace(gcfg, kv_cache_dtype="int8"), weights=gweights)
    emit(summary)
    del gweights
    torch.cuda.empty_cache()
    # phase 8i: yi-6b split over a 2-wide model axis, two processes; then
    # hymba-1.5b, whose heads and vocabulary the axis does not divide
    tp_counts, tp_sizes, summary = tp_serve_phase()
    emit(summary)
    hy_tp_counts, hy_tp_sizes, summary = tp_serve_phase(
        configs.get(TP_HYBRID_ARCH), prompt=TP_HYBRID_PROMPT,
        gen=TP_HYBRID_GEN, host_ops=GLOO_CUDA_HOST_OPS)
    emit(summary)
    whisper_counts, whisper_sizes, summary = model_phase(
        configs.get(WHISPER_ARCH), prompt=WHISPER_FRAMES)
    emit(summary)
    vlm_counts, vlm_sizes, summary = model_phase(
        dataclasses.replace(configs.get(VLM_ARCH), n_layers=VLM_LAYERS))
    emit(summary)
    # training, after the serves and before the chaos, async and autotune
    # phases (the soak leaves the process's host pages slow, PERF.md 7)
    train_steps, train_sizes, summary, loop_8f = train_phase()
    emit(summary)
    emit(mesh_train_phase(loop_8f))
    del loop_8f
    train_counts = {k: sum(r["launches"].get(k, 0) for r in train_steps)
                    for k in KERNELS}

    rng = np.random.default_rng(SEED)
    rows = {}
    for d in (2, 3):
        for name in ("chain_diag_1d", "chain_matrix_1d", "chain_project_1d"):
            rows[name] = kernel_case(name, (N_FLAT, d), rng, "flat 2**24")
    for i, size in enumerate(("median request", "largest request")):
        for d in (2, 3):
            for name in ("chain_diag_1d", "chain_matrix_1d"):
                kernel_case(name, (sizes_affine["all"][i], d), rng, size)
            kernel_case("chain_project_1d", (sizes["projective"][i], d), rng,
                        f"{size} (projective, mixed serve)")
    # chain_diag_batch_2d's vector kernel at the largest d = 3 bucket too
    # (three column patterns), and its scalar kernel, untimed: a row of
    # no multiple of 4 floats, and the largest bucket off alignment
    kernel_case("chain_diag_batch_2d", largest_affine["diag", 3], rng,
                "largest d = 3 bucket")
    # chain_matrix_batch_2d's vector kernel at the largest d = 3 bucket
    # (staged groups of 4 points), untimed at B > 1024, and its scalar
    # kernel, untimed: rows of no whole group, the largest buckets off
    # alignment
    matrix_d3 = kernel_case("chain_matrix_batch_2d",
                            largest_affine["matrix", 3], rng,
                            "largest d = 3 bucket")
    for shape, size, off in (
            ((1100, 8, 3), "B > 1024, d = 3, row of 2 groups", False),
            ((1500, 16, 2), "B > 1024, row of 8 groups", False),
            ((5, 13, 2), "row of 13 points", False),
            ((3, 6, 3), "d = 3, row of 6 points", False),
            ((1100, 13, 3), "B > 1024, row of 13 points", False),
            (largest_affine["matrix"], "largest bucket, off alignment", True),
            (largest_affine["matrix", 3],
             "largest d = 3 bucket, off alignment", True)):
        kernel_case("chain_matrix_batch_2d", shape, rng, size,
                    check_only=True, misaligned=off)
    kernel_case("chain_diag_batch_2d", (5, 13, 3), rng, "row of 39 floats",
                check_only=True)
    kernel_case("chain_diag_batch_2d", (1500, 10, 2), rng,
                "B > 1024, row of 20 floats", check_only=True)
    kernel_case("chain_diag_batch_2d", (1100, 13, 3), rng,
                "B > 1024, row of 39 floats", check_only=True)
    kernel_case("chain_diag_batch_2d", largest_affine["diag"], rng,
                "largest bucket, off alignment", check_only=True,
                misaligned=True)
    # chain_project_1d untimed: its scalar kernel below 2**19 points (the
    # timed request rows above run it too) and at points off 16-byte
    # alignment, and the 16-byte kernel's tail of N mod 4 points
    for d in (2, 3):
        for n, size, off in ((3, "N = 3", False), (1001, "N = 1001", False),
                             ((1 << 19) - 1, "N = 2**19 - 1", False),
                             (CLOUD_POINTS + 3, "N = 2**20 + 3", False),
                             (CLOUD_POINTS, "off alignment", True)):
            kernel_case("chain_project_1d", (n, d), rng, size,
                        check_only=True, misaligned=off)
    for name, kind in (("chain_diag_batch_2d", "diag"),
                       ("chain_matrix_batch_2d", "matrix")):
        rows[name] = kernel_case(name, largest_affine[kind], rng,
                                 "largest bucket")
    rows["chain_project_batch_2d"] = kernel_case(
        "chain_project_batch_2d", largest["projective"], rng,
        "largest bucket (mixed serve)")
    # chain_project_batch_2d's vector kernel at the graphics bucket and,
    # untimed, at B > 1024, and its scalar kernel, untimed: rows of no
    # whole group, B > 1024, the largest and the graphics bucket off
    # alignment
    project_graphics = kernel_case("chain_project_batch_2d",
                                   (FRAMES, FRAME_POINTS, 3), rng,
                                   "graphics bucket")
    for shape, size, off in (
            ((1100, 8, 3), "B > 1024, d = 3, row of 2 groups", False),
            ((1500, 16, 2), "B > 1024, row of 4 groups", False),
            ((5, 13, 2), "row of 13 points", False),
            ((3, 6, 3), "d = 3, row of 6 points", False),
            ((1100, 13, 3), "B > 1024, row of 13 points", False),
            (largest["projective"], "largest bucket, off alignment", True),
            ((FRAMES, FRAME_POINTS, 3), "graphics bucket, off alignment",
             True)):
        kernel_case("chain_project_batch_2d", shape, rng, size,
                    check_only=True, misaligned=off)
    for d in (2, 3):
        for name in Q_FLAT.values():
            rows[name] = kernel_case_q(name, (N_FLAT, d), rng, "flat 2**24")
    for i, size in enumerate(("median q request", "largest q request")):
        for d in (2, 3):
            for name in Q_FLAT.values():
                kernel_case_q(name, (sizes_q[i], d), rng, size)
    for kind, name in Q_BATCH.items():
        rows[name] = kernel_case_q(name, largest_q[kind], rng,
                                   "largest q bucket")
    # chain_matrix_batch_2d_q's 16-byte kernel at d = 3 and its scalar
    # kernel, untimed: rows of no multiple of 8 words, B > 1024, the
    # largest q bucket off alignment
    for shape, size, off in (
            ((4, 4096, 3), "d = 3, row of 12288 words", False),
            ((1100, 16, 3), "B > 1024, row of 48 words", False),
            ((3, 1001, 3), "row of 3003 words", False),
            ((3, 1001, 2), "row of 2002 words", False),
            ((1100, 13, 2), "B > 1024, row of 26 words", False),
            (largest_q["matrix"], "largest q bucket, off alignment", True)):
        kernel_case_q("chain_matrix_batch_2d_q", shape, rng, size,
                      check_only=True, misaligned=off)
    # chain_diag_batch_2d_q's 16-byte kernel at d = 3 (three column
    # patterns) and B > 1024, and its scalar kernel, untimed: rows of no
    # multiple of 8 words, B > 1024, the largest q bucket off alignment
    for shape, size, off in (
            ((5, 24, 3), "d = 3, row of 9 vectors", False),
            ((4, 4096, 3), "d = 3, row of 12288 words", False),
            ((1100, 8, 3), "B > 1024, row of 24 words", False),
            ((3, 1001, 3), "row of 3003 words", False),
            ((5, 13, 2), "row of 26 words", False),
            ((1100, 13, 3), "B > 1024, row of 39 words", False),
            (largest_q["diag"], "largest q bucket, off alignment", True)):
        kernel_case_q("chain_diag_batch_2d_q", shape, rng, size,
                      check_only=True, misaligned=off)

    bf16, f32 = torch.bfloat16, torch.float32
    bench, cloud = "kernel_bench", "cloud"
    # the sizes the eager and model kernels are checked at, from here on
    _build.reset_launch_counts()
    # the last row of each kernel is the kernels line's
    for name, shape, dtype, size in (
            ("affine_2d", (1024, 1024), bf16, bench),
            ("affine_2d", (CLOUD_POINTS, 2), f32, cloud),
            ("affine_2d", (1024, 1024), f32, bench),
            ("vecadd_2d", (1024, 1024), bf16, bench),
            ("vecadd_2d", (CLOUD_POINTS, 2), f32, cloud),
            ("vecadd_2d", (1024, 1024), f32, bench),
            ("matmul_2d", (1024, 1024, 1024), f32, bench),
            ("matmul_2d", (CLOUD_POINTS, 2, 2), f32, "rotate"),
            ("matmul_2d", (4096, 4096, 4096), bf16, "4096^3"),
            ("matmul_2d", (1024, 1024, 1024), bf16, bench)):
        rows[name] = eager_case(name, shape, dtype, rng, size)
        rows[name, size] = rows[name]
    # matmul_2d's tensor-core regime through its per-thread loads (K and
    # N no multiples of 8, no TMA) and its skinny regime in bfloat16
    eager_case("matmul_2d", (130, 1024, 70), bf16, rng, "staged loads",
               check_only=True)
    eager_case("matmul_2d", (CLOUD_POINTS, 2, 2), bf16, rng, "rotate",
               check_only=True)
    # the residual adds of the hymba-1.5b serve (batch 4, prompt 2048:
    # 8192 rows), prefill and decode, beside the kernels line's row
    rows_n = MODEL_BATCH * MODEL_PROMPT
    vecadd_hymba = eager_case("vecadd_2d", (rows_n, 1600), bf16, rng,
                              "hymba prefill residual add")
    eager_case("vecadd_2d", (MODEL_BATCH, 1600), bf16, rng,
               "hymba decode residual add", check_only=True)
    # vecadd_2d's scalar kernel (a base off 16-byte alignment) and the
    # 16-byte one's scalar tail (totals no multiple of 8), M = 1
    xz = ("x", "z")
    for shape, dtype, size, off in (
            ((rows_n, 1600), bf16, "prefill shape, off alignment", xz),
            ((1, 1600), bf16, "M = 1", ()),
            ((1, 1603), bf16, "M = 1, total 1603", ()),
            ((4097, 3), f32, "total 12291", ()),
            ((4097, 3), f32, "total 12291, off alignment", xz)):
        eager_case("vecadd_2d", shape, dtype, rng, size, check_only=True,
                   misaligned=off)
    # affine_2d's three regimes beyond the timed rows: flat vectors with a
    # scalar tail (totals no multiple of the width), column vectors at
    # narrow, ragged-tile and hymba widths, and the scalar kernel (N = 3,
    # N = 100, x or s off 16-byte alignment)
    for shape, dtype, size, off in (
            ((4097, 1), f32, "flat, N = 1, total 4097", ()),
            ((CLOUD_POINTS + 1, 2), bf16, "flat, N = 2, total 2**21 + 2",
             ()),
            ((1001, 4), f32, "flat, N = 4", ()),
            ((3001, 8), bf16, "flat, N = 8", ()),
            ((4097, 8), f32, "column, N = 8", ()),
            ((999, 12), f32, "column, N = 12", ()),
            ((rows_n, 1600), bf16, "column, N = 1600", ()),
            ((MODEL_BATCH, 1600), bf16, "column, M = 4", ()),
            ((1, 1 << 20), f32, "column, M = 1", ()),
            ((CLOUD_POINTS, 3), f32, "scalar, N = 3", ()),
            ((4097, 100), bf16, "scalar, N = 100", ()),
            ((CLOUD_POINTS, 2), f32, "scalar, x off alignment", ("x",)),
            ((1024, 1024), bf16, "scalar, x off alignment", ("x",)),
            ((1024, 1024), f32, "scalar, s off alignment", ("s",))):
        eager_case("affine_2d", shape, dtype, rng, size, check_only=True,
                   misaligned=off)
    # the model kernels at every shape the serve gives them; the last row
    # of each kernel is the kernels line's
    last = MODEL_PROMPT + MODEL_GEN - 1
    # rmsnorm.cu's scalar kernel (x off 16-byte alignment; rows of 33 or
    # 100 values, no multiple of 16 bytes) and both kernels at M = 1
    for shape, dtype, size, off in (
            ((rows_n, 1600), bf16, "prefill shape, off alignment", True),
            ((MODEL_BATCH, 3200), f32, "decode SSM shape, off alignment",
             True),
            ((rows_n, 33), bf16, "N = 33", False),
            ((rows_n, 100), f32, "N = 100", False),
            ((1, 1600), bf16, "M = 1", False),
            ((1, 3200), f32, "M = 1", False),
            ((1, 100), bf16, "M = 1, N = 100", False)):
        model_case("rmsnorm_2d", shape, dtype, rng, size, check_only=True,
                   misaligned=off)
    # rope.cu's scalar kernel: a half row of no multiple of 16 bytes (D =
    # 20 in bfloat16) and x one element off 16-byte alignment
    for shape, size, off in (((20, MODEL_PROMPT, 20), "D = 20", False),
                             ((100, MODEL_PROMPT, 64),
                              "prefill q, off alignment", True),
                             ((20, 1, 64), "decode k, off alignment", True)):
        model_case("rope_3d", shape, bf16, rng, size, check_only=True,
                   misaligned=off)
    rope_decode = {}
    for name, shape, dtype, size, window, pos0, only in (
            ("rmsnorm_2d", (MODEL_BATCH, 3200), f32,
             "decode SSM gated norm", None, 0, True),
            ("rmsnorm_2d", (rows_n, 3200), f32, "SSM gated norm", None, 0,
             False),
            ("rmsnorm_2d", (MODEL_BATCH, 1600), bf16, "decode", None, 0,
             False),
            ("rmsnorm_2d", (rows_n, 1600), bf16, "prefill", None, 0, False),
            ("rope_3d", (20, 1, 64), bf16, "decode k", None, last, False),
            ("rope_3d", (100, 1, 64), bf16, "decode q", None, last, False),
            ("rope_3d", (20, MODEL_PROMPT, 64), bf16, "prefill k", None, 0,
             False),
            ("rope_3d", (100, MODEL_PROMPT, 64), bf16, "prefill q", None, 0,
             False),
            ("flash_attention_3d", (100, 20, 2000, 64), bf16,
             "prompt 2000, window edge inside a tile", 1000, 0, True),
            ("flash_attention_3d", (100, 20, 2000, 64), bf16,
             "prompt 2000", 1024, 0, True),
            ("flash_attention_3d", (100, 20, MODEL_PROMPT, 64), bf16,
             "prefill", 1024, 0, False),
            ("ssd_intra", (32, 256, 50, 64, 16), f32, "prefill, float32",
             None, 0, True),
            ("ssd_intra", (32, 256, 50, 64, 16), bf16, "prefill", None, 0,
             False)):
        rows[name] = model_case(name, shape, dtype, rng, size, window=window,
                                pos0=pos0, check_only=only)
        if size.startswith("decode") and name == "rope_3d":
            rope_decode[size.removeprefix("decode ")] = rows[name]
    # ssd_intra at mamba2-130m's prefill shape (batch 4 x 2048 tokens, 24
    # heads of 64, state 128), beside the kernels line's hymba row
    ssd_mamba2 = model_case("ssd_intra", (32, 256, 24, 64, 128), bf16, rng,
                            "mamba2-130m prefill")
    # the model kernels at every shape the granite-moe-3b-a800m serve
    # gives them: attention only, 24 query and 8 kv heads of 64 (a GQA
    # group of 3), no window, d = 1536; the timed rows are the kernels
    # line's "granite" entries
    gcfg = configs.get(GRANITE_ARCH)
    gq, gkv = MODEL_BATCH * gcfg.n_heads, MODEL_BATCH * gcfg.n_kv_heads
    ghd, gd = gcfg.head_dim, gcfg.d_model
    granite = {}
    for name, shape, size, pos0, only in (
            ("rmsnorm_2d", (MODEL_BATCH, gd), "granite decode", 0, True),
            ("rmsnorm_2d", (rows_n, gd), "granite prefill", 0, False),
            ("rope_3d", (gkv, 1, ghd), "granite decode k", last, True),
            ("rope_3d", (gq, 1, ghd), "granite decode q", last, True),
            ("rope_3d", (gkv, MODEL_PROMPT, ghd), "granite prefill k", 0,
             True),
            ("rope_3d", (gq, MODEL_PROMPT, ghd), "granite prefill q", 0,
             False),
            ("flash_attention_3d", (gq, gkv, MODEL_PROMPT, ghd),
             "granite prefill", 0, False)):
        row = model_case(name, shape, bf16, rng, size, window=gcfg.window,
                         pos0=pos0, check_only=only)
        if not only:
            granite[name] = row
    granite["vecadd_2d"] = eager_case("vecadd_2d", (rows_n, gd), bf16, rng,
                                      "granite prefill residual add")
    eager_case("vecadd_2d", (MODEL_BATCH, gd), bf16, rng,
               "granite decode residual add", check_only=True)
    # the model kernels at every shape the whisper-medium serve gives
    # them: 16 query and kv heads of 64 (no GQA), no RoPE, d = 1024; the
    # encoder's 4 x 1500 frames and the decoder's one token a row; flash
    # without a mask over the encoder, the cross-attention's one query
    # against the 1500 encoder keys (prefill and every decode step) and
    # the decoder's causal self-attention prefill of one token
    wcfg = configs.get(WHISPER_ARCH)
    wq, wkv = MODEL_BATCH * wcfg.n_heads, MODEL_BATCH * wcfg.n_kv_heads
    whd, wd = wcfg.head_dim, wcfg.d_model
    enc_rows = MODEL_BATCH * WHISPER_FRAMES
    whisper = {}
    for name, shape, size, t, causal in (
            ("rmsnorm_2d", (MODEL_BATCH, wd), "whisper decoder", None, True),
            ("rmsnorm_2d", (enc_rows, wd), "whisper encoder", None, True),
            ("flash_attention_3d", (wq, wkv, 1, whd),
             "whisper decoder self-attention prefill", 1, True),
            ("flash_attention_3d", (wq, wkv, 1, whd),
             "whisper cross-attention", WHISPER_FRAMES, False),
            ("flash_attention_3d", (wq, wkv, WHISPER_FRAMES, whd),
             "whisper encoder", None, False)):
        whisper.setdefault(name, {})[size] = model_case(
            name, shape, bf16, rng, size, t=t, causal=causal)
    for shape, size in (((MODEL_BATCH, wd), "whisper decoder residual add"),
                        ((enc_rows, wd), "whisper encoder residual add")):
        whisper.setdefault("vecadd_2d", {})[size] = eager_case(
            "vecadd_2d", shape, bf16, rng, size)
    # ... and the internvl2-76b serve: 64 query and 8 kv heads of 128 (a
    # GQA group of 8), no window, d = 8192, the hymba serve's lengths
    vcfg = configs.get(VLM_ARCH)
    vq, vkv = MODEL_BATCH * vcfg.n_heads, MODEL_BATCH * vcfg.n_kv_heads
    vhd, vd = vcfg.head_dim, vcfg.d_model
    internvl2 = {}
    for name, shape, size, pos0 in (
            ("rmsnorm_2d", (MODEL_BATCH, vd), "internvl2 decode", 0),
            ("rmsnorm_2d", (rows_n, vd), "internvl2 prefill", 0),
            ("rope_3d", (vkv, 1, vhd), "internvl2 decode k", last),
            ("rope_3d", (vq, 1, vhd), "internvl2 decode q", last),
            ("rope_3d", (vkv, MODEL_PROMPT, vhd), "internvl2 prefill k", 0),
            ("rope_3d", (vq, MODEL_PROMPT, vhd), "internvl2 prefill q", 0),
            ("flash_attention_3d", (vq, vkv, MODEL_PROMPT, vhd),
             "internvl2 prefill", 0)):
        internvl2.setdefault(name, {})[size] = model_case(
            name, shape, bf16, rng, size, window=vcfg.window, pos0=pos0)
    for shape, size in (((MODEL_BATCH, vd), "internvl2 decode residual add"),
                        ((rows_n, vd), "internvl2 prefill residual add")):
        internvl2.setdefault("vecadd_2d", {})[size] = eager_case(
            "vecadd_2d", shape, bf16, rng, size)
    # the model kernels at every shape hymba-1.5b's training gives them
    # (a micro-batch of 2 x 2048 tokens), each also with the plain vjp
    # its kernels.grad Function runs in the backward pass
    tq, tkv = TRAIN_MICRO * 25, TRAIN_MICRO * 5
    train_rows = {}
    for name, shape, dtype, size, window in (
            ("rmsnorm_2d", (TRAIN_MICRO * TRAIN_SEQ, 3200), f32,
             "train SSM gated norm", None),
            ("rmsnorm_2d", (TRAIN_MICRO * TRAIN_SEQ, 1600), bf16, "train",
             None),
            ("rope_3d", (tkv, TRAIN_SEQ, 64), bf16, "train k", None),
            ("rope_3d", (tq, TRAIN_SEQ, 64), bf16, "train q", None),
            ("flash_attention_3d", (tq, tkv, TRAIN_SEQ, 64), bf16, "train",
             1024),
            ("ssd_intra", (TRAIN_MICRO * TRAIN_SEQ // 256, 256, 50, 64, 16),
             bf16, "train", None)):
        row = model_case(name, shape, dtype, rng, size, window=window)
        row.update(plain_backward_case(name, shape, dtype, rng,
                                       window=window))
        train_rows[name] = row
    row = eager_case("vecadd_2d", (TRAIN_MICRO * TRAIN_SEQ, 1600), bf16, rng,
                     "train residual add")
    row.update(plain_backward_case("vecadd_2d",
                                   (TRAIN_MICRO * TRAIN_SEQ, 1600), bf16,
                                   rng))
    train_rows["vecadd_2d"] = row
    # ... and phase 8i's ranks: yi-6b's 32/4 heads of 128 split over a
    # 2-wide model axis (16 query and 2 kv heads a rank, a GQA group of
    # 8), no window, d = 4096 (norms and residual adds on whole rows)
    ycfg, tp = configs.get(TP_ARCH), TP_MESH[1]
    yq, ykv = MODEL_BATCH * ycfg.n_heads // tp, \
        MODEL_BATCH * ycfg.n_kv_heads // tp
    yhd, yd = ycfg.head_dim, ycfg.d_model
    yi_tp = {}
    for name, shape, size, pos0 in (
            ("rmsnorm_2d", (MODEL_BATCH, yd), "yi-6b mesh decode", 0),
            ("rmsnorm_2d", (rows_n, yd), "yi-6b mesh prefill", 0),
            ("rope_3d", (ykv, 1, yhd), "yi-6b mesh decode k", last),
            ("rope_3d", (yq, 1, yhd), "yi-6b mesh decode q", last),
            ("rope_3d", (ykv, MODEL_PROMPT, yhd), "yi-6b mesh prefill k", 0),
            ("rope_3d", (yq, MODEL_PROMPT, yhd), "yi-6b mesh prefill q", 0),
            ("flash_attention_3d", (yq, ykv, MODEL_PROMPT, yhd),
             "yi-6b mesh prefill", 0)):
        yi_tp.setdefault(name, {})[size] = model_case(
            name, shape, bf16, rng, size, window=ycfg.window, pos0=pos0)
    for shape, size in (((MODEL_BATCH, yd), "yi-6b mesh decode residual add"),
                        ((rows_n, yd), "yi-6b mesh prefill residual add")):
        yi_tp.setdefault("vecadd_2d", {})[size] = eager_case(
            "vecadd_2d", shape, bf16, rng, size)
    # ... and its hymba-1.5b run: every head on each rank, the prompt's
    # 1536 positions split 768 a rank (queries; keys from window - 1
    # before, here from position 0: rank 0's 768 keys, rank 1's 1536 with
    # its queries at offset 768), the SSM's 6 chunks 3 a rank, the SSM
    # branch's norms on its 3072 rows; decode on whole rows (the kernels'
    # decode shapes are the serve without a mesh's)
    hcfg = configs.get(TP_HYBRID_ARCH)
    hq, hkv = MODEL_BATCH * hcfg.n_heads, MODEL_BATCH * hcfg.n_kv_heads
    hd, hdm, half = hcfg.head_dim, hcfg.d_model, TP_HYBRID_PROMPT // tp
    hrows = MODEL_BATCH * TP_HYBRID_PROMPT
    hchunks = hrows // hcfg.ssm_chunk // tp
    hks = max(0, half - hcfg.window + 1)     # rank 1's first key
    hlast = TP_HYBRID_PROMPT + TP_HYBRID_GEN - 1
    hy_tp = {}
    for name, shape, dtype, size, pos0, t, q_off in (
            ("rmsnorm_2d", (MODEL_BATCH, hdm), bf16, "hymba mesh decode", 0,
             None, 0),
            ("rmsnorm_2d", (MODEL_BATCH, hcfg.ssm_inner), f32,
             "hymba mesh decode SSM gated norm", 0, None, 0),
            ("rmsnorm_2d", (hrows, hdm), bf16, "hymba mesh prefill", 0,
             None, 0),
            ("rmsnorm_2d", (hrows // tp, hdm), bf16,
             "hymba mesh prefill SSM branch gain", 0, None, 0),
            ("rmsnorm_2d", (hrows // tp, hcfg.ssm_inner), f32,
             "hymba mesh prefill SSM gated norm", 0, None, 0),
            ("rope_3d", (hkv, 1, hd), bf16, "hymba mesh decode k", hlast,
             None, 0),
            ("rope_3d", (hq, 1, hd), bf16, "hymba mesh decode q", hlast,
             None, 0),
            ("rope_3d", (hkv, TP_HYBRID_PROMPT, hd), bf16,
             "hymba mesh prefill k", 0, None, 0),
            ("rope_3d", (hq, half, hd), bf16, "hymba mesh prefill q", 0,
             None, 0),
            ("flash_attention_3d", (hq, hkv, half, hd), bf16,
             "hymba mesh prefill rank 0", 0, half, 0),
            ("flash_attention_3d", (hq, hkv, half, hd), bf16,
             "hymba mesh prefill rank 1", 0, 2 * half - hks, half - hks),
            ("ssd_intra", (hchunks, hcfg.ssm_chunk, hcfg.ssm_heads,
                           hcfg.ssm_headdim, hcfg.ssm_state), bf16,
             "hymba mesh prefill", 0, None, 0)):
        hy_tp.setdefault(name, {})[size] = model_case(
            name, shape, dtype, rng, size, window=hcfg.window, pos0=pos0,
            t=t, q_offset=q_off)
    for shape, size in (((MODEL_BATCH, hdm),
                         "hymba mesh decode residual add"),
                        ((hrows, hdm), "hymba mesh prefill residual add")):
        hy_tp.setdefault("vecadd_2d", {})[size] = eager_case(
            "vecadd_2d", shape, bf16, rng, size)
    # every size the serves and the training launched a kernel with was
    # checked above
    checked = _build.launch_sizes()
    served_sizes = {HYMBA_ARCH: hymba_sizes, GRANITE_ARCH: granite_sizes,
                    f"{GRANITE_ARCH} int8 KV cache": int8_sizes,
                    WHISPER_ARCH: whisper_sizes, VLM_ARCH: vlm_sizes,
                    f"{HYMBA_ARCH} training": train_sizes,
                    f"{TP_ARCH} on a 1x2 mesh": tp_sizes,
                    f"{TP_HYBRID_ARCH} on a 1x2 mesh": hy_tp_sizes}
    for arch, served in served_sizes.items():
        for name in MODEL_PATH_KERNELS:
            missed = served[name] - checked[name]
            if missed:
                raise SystemExit(f"{name}: the {arch} serve launched it with "
                                 f"sizes {sorted(missed)}, which no check "
                                 f"held against its plain version")
    emit({"phase": "model shapes checked",
          "sizes": {arch: {k: sorted(served[k]) for k in MODEL_PATH_KERNELS}
                    for arch, served in served_sizes.items()}})
    # the primitives phase's comparison with the kernels alone: the
    # sequential pipeline's four launches against the fused chain's one
    fused = kernel_case("chain_matrix_1d", (CLOUD_POINTS, 2), rng, cloud)
    seq_ms = (3 * rows["affine_2d", cloud]["ms"]
              + rows["matmul_2d", "rotate"]["ms"])
    emit({"phase": "primitives (kernels alone)", "points": CLOUD_POINTS,
          "sequential_kernels_ms": seq_ms, "fused_kernel_ms": fused["ms"],
          "kernel_time_ratio": seq_ms / fused["ms"]})

    # the launch knobs and the tuners, after every timed phase and
    # before the soak (which slows the flushes after it)
    emit(autotune_phase(largest_affine, largest, largest_q))

    # the recovery ladder and the async front end, after every timed
    # phase: after the chaos soak (with or without faults) the process's
    # flushes unpack 3-5x slower, their result arrays landing on freshly
    # faulted host pages (PERF.md section 7), which must not reach the
    # timings above
    soak_counts, summary = chaos_soak_phase()
    emit(summary)
    chaos_counts, summary = chaos_mixed_phase()
    emit(summary)
    emit(traced_flush_phase())
    async_counts, summary = async_phase()
    emit(summary)

    kernels = []
    for name, (source, replaces, kind) in KERNELS.items():
        r = rows[name]
        # each kernel's launches come from the path that runs it: the
        # mixed serve for the float chain kernels, the q-mixed serve for
        # the int16 ones, the primitives phase for the eager ones, the
        # hymba-1.5b serve (prefill and decode) for the model kernels
        launches = hymba_counts[name] if kind == "model" \
            else eager_counts[name] if kind == "eager" \
            else q_counts[name] if name.endswith("_q") else counts[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "launches_mixed": counts[name],
                        "launches_q_mixed": q_counts[name],
                        "launches_graphics": graphics_counts[name],
                        "launches_primitives": eager_counts[name],
                        "launches_hymba": hymba_counts[name],
                        "launches_granite": granite_counts[name],
                        "launches_granite_int8": int8_counts[name],
                        "launches_whisper": whisper_counts[name],
                        "launches_internvl2": vlm_counts[name],
                        "launches_yi_mesh_rank0": tp_counts.get(name, 0),
                        "launches_hymba_mesh_rank0": hy_tp_counts.get(name,
                                                                      0),
                        "launches_train": train_counts[name],
                        "launches_scene": scene_counts[name],
                        "launches_chaos_soak": soak_counts[name],
                        "launches_chaos_mixed": chaos_counts[name],
                        "launches_async": async_counts[name],
                        "shape": r["shape"], "dtype": r.get("dtype", "float32"),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "composite_ms": r["composite_ms"],
                        "library": r["library"], "copy_ms": r.get("copy_ms")})
    kernels[list(KERNELS).index("vecadd_2d")]["hymba_prefill"] = {
        k: vecadd_hymba[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "copy_ms")}
    kernels[list(KERNELS).index("rope_3d")]["decode"] = {
        head: {k: r[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "composite_ms", "copy_ms")}
        for head, r in rope_decode.items()}
    kernels[list(KERNELS).index("chain_matrix_batch_2d")]["largest_d3"] = {
        k: matrix_d3[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "copy_ms")}
    kernels[list(KERNELS).index("chain_project_batch_2d")]["graphics"] = {
        k: project_graphics[k] for k in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "composite_ms",
                                         "copy_ms")}
    kernels[list(KERNELS).index("ssd_intra")]["mamba2_prefill"] = {
        k: ssd_mamba2[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "composite_ms", "copy_ms")}
    for name, r in granite.items():
        kernels[list(KERNELS).index(name)]["granite"] = {
            k: r.get(k) for k in ("shape", "dtype", "window", "max_abs_err",
                                  "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "composite_ms", "copy_ms")}
        kernels[list(KERNELS).index(name)]["granite"]["launches"] = \
            granite_counts[name]
    for arch, timed, counts_arch in (("whisper", whisper, whisper_counts),
                                     ("internvl2", internvl2, vlm_counts),
                                     ("yi_mesh_rank0", yi_tp, tp_counts),
                                     ("hymba_mesh_rank0", hy_tp,
                                      hy_tp_counts)):
        for name, by_size in timed.items():
            kernels[list(KERNELS).index(name)][arch] = {
                "launches": counts_arch[name],
                "rows": {size: {k: r.get(k) for k in (
                    "shape", "t", "causal", "q_offset", "dtype",
                    "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "composite_ms", "copy_ms")}
                    for size, r in by_size.items()}}
    for name, r in train_rows.items():
        kernels[list(KERNELS).index(name)]["train"] = {
            "launches_per_step": train_steps[-1]["launches"][name],
            "plain_backwards_per_step":
                train_steps[-1]["plain_backwards"][name],
            **{k: r.get(k) for k in (
                "shape", "dtype", "window", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "composite_ms",
                "copy_ms", "plain_backward_ms")}}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
