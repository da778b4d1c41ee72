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
  8. serve (hymba-1.5b): the model stack's serving path at full width
     (1.59 B parameters, bfloat16, random weights from seed 0): batch 4,
     2048-token prompts (numpy seed 0) and 16 generated tokens through
     ``launch.serve.serve_batch``, with prefill and per-token decode ms
     (CUDA events), tokens/s and peak memory; launch counts zeroed before
     the serve and read after the prefill and after the decode, each of
     ``rmsnorm_2d`` (5L+1 a pass), ``rope_3d`` (2L), ``flash_attention_3d``
     and ``ssd_intra`` (L, prefill only) and ``vecadd_2d`` (2L) held to
     its expected count; then the same model on the plain versions
     (``dispatch.use_backend("ref")``) teacher-forced with the served
     tokens, every step's logits within HYMBA_LOGITS_RTOL (relative RMS)
     of the kernel path's, and the greedy-token agreement reported; the
     distinct sizes each kernel was launched with in the serve are kept
     for phase 9;
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
     every size a kernel was launched with in the hymba serve must be
     among the sizes these checks launched it with;
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
     ``vecadd_2d`` also carries its hymba prefill row, ``rope_3d`` its
     decode rows, ``ssd_intra`` its mamba2-130m row,
     ``chain_matrix_batch_2d`` its largest d = 3 bucket's row,
     ``chain_project_batch_2d`` its graphics bucket's row), then the
     device line last.
"""
from __future__ import annotations

import json
import math
import os
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

from repro_torch import autotune, configs, graphics, obs, quantize, serving  # noqa: E402
from repro_torch.autotune import cache as tcache  # noqa: E402
from repro_torch.autotune import costmodel, search  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import transform_engine as te  # noqa: E402
from repro_torch.core.morphosys import intel, programs  # noqa: E402
from repro_torch.kernels import _build, dispatch, opcount  # noqa: E402
from repro_torch.kernels import matmul as matmul_op  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_op  # noqa: E402
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
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

import torch_bounds as bounds  # noqa: E402
import torch_chaos  # noqa: E402

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
#: the serve (hymba-1.5b) phase: full width, batch 4, 2048-token prompts
HYMBA_ARCH, HYMBA_BATCH, HYMBA_PROMPT, HYMBA_GEN = "hymba-1.5b", 4, 2048, 16
#: the kernel path's logits against the plain path's, relative RMS, a
#: step -- an envelope, not the correctness check (phase 9 holds each
#: kernel to its per-element bound at every shape of the path): about 6
#: sites a layer round differently on the two paths (five rmsnorm_2d
#: and one flash_attention_3d output, which may land one bfloat16 ulp
#: apart, 2**-8 to 2**-7 relative -- the tensor-core flash kernel also
#: rounds P to bfloat16, within 2**-9 max|v| of its output; rope_3d and
#: vecadd_2d are bitwise, SSD float32), so over 32 layers and the final norm
#: sqrt(6 * 32 + 1) * 2**-7 = 0.109 if each is a full ulp at the top of
#: the range and they add in quadrature (PERF.md)
HYMBA_LOGITS_RTOL = math.sqrt(6 * 32 + 1) * 2.0 ** -7
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


# -- the model stack: serve (hymba-1.5b) ------------------------------------------

def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_numel(v) for v in tree)
    return tree.numel()


def expected_launches(cfg, gen: int) -> tuple[dict, dict]:
    """(prefill, decode) launches of the model kernels for a hybrid model
    of L layers: a layer's prefill runs rmsnorm_2d 5 times (the attention
    norm, the SSM's gated norm, the two branch gains, the MLP norm),
    rope_3d twice (q, k), flash_attention_3d and ssd_intra once and
    vecadd_2d twice (two residual adds); the final norm adds one
    rmsnorm_2d.  A decode step is the same without flash attention and
    SSD (``_cached_attention`` and the recurrent step are plain torch)."""
    L = cfg.n_layers
    step = {"rmsnorm_2d": 5 * L + 1, "rope_3d": 2 * L,
            "flash_attention_3d": 0, "ssd_intra": 0, "vecadd_2d": 2 * L}
    prefill = dict(step, flash_attention_3d=L, ssd_intra=L)
    return prefill, {k: gen * v for k, v in step.items()}


def hymba_phase(device: str = "cuda") -> tuple[dict, dict, dict]:
    """Serve hymba-1.5b at full width from random weights (seed 0): batch
    HYMBA_BATCH, HYMBA_PROMPT-token prompts, HYMBA_GEN tokens through
    ``serve_batch``, launch counts zeroed before it and read after the
    prefill and after the decode; then the same model on the plain
    versions (``use_backend("ref")``) teacher-forced with the kernel
    path's tokens, every step's logits within HYMBA_LOGITS_RTOL (relative
    RMS).  Returns (the launches of the served run, the distinct sizes of
    those launches by kernel, the summary)."""
    cfg = configs.get(HYMBA_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _tree_numel(params)
    # the analytic count leaves out conv_b and one of the three per-head
    # SSM vectors (models/config.py): 0.007 % of hymba-1.5b
    if abs(n_params - cfg.param_count()) > 1e-3 * cfg.param_count():
        raise SystemExit(f"hymba: {n_params} parameters, param_count() "
                         f"{cfg.param_count()}")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (HYMBA_BATCH, HYMBA_PROMPT)).astype(np.int32)
    # warm-up (cuBLAS handles, the kernels' first launches), not counted
    serve_batch(cfg, params, prompts[:, :64], gen_tokens=2, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    trace = {}
    t0 = time.perf_counter()
    tokens = serve_batch(cfg, params, prompts, gen_tokens=HYMBA_GEN,
                         model=model, trace=trace)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total, sizes = _build.launch_counts(), _build.launch_sizes()
    pre = trace["launches_prefill"]
    dec = {k: total[k] - pre[k] for k in total}
    want_pre, want_dec = expected_launches(cfg, HYMBA_GEN)
    for name in MODEL_PATH_KERNELS:
        if pre[name] != want_pre[name] or dec[name] != want_dec[name]:
            raise SystemExit(f"hymba: {name} launched {pre[name]} + "
                             f"{dec[name]}, expected {want_pre[name]} + "
                             f"{want_dec[name]}")
    require_launched(total, MODEL_PATH_KERNELS, "hymba serve")
    logits = trace["logits"]
    if tokens.shape != (HYMBA_BATCH, HYMBA_GEN) or not all(
            lg.shape == (HYMBA_BATCH, cfg.vocab_size)
            and bool(torch.isfinite(lg).all()) for lg in logits):
        raise SystemExit("hymba: bad tokens or non-finite logits")

    # the plain path on the card, teacher-forced with the kernel path's tokens
    tok = torch.from_numpy(tokens).long().to(device)
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        cache = model.init_cache(HYMBA_BATCH, HYMBA_PROMPT + HYMBA_GEN,
                                 device=device)
        lg, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompts).long().to(device)},
            cache)
        ref_logits = [lg]
        for i in range(HYMBA_GEN):
            lg, cache = model.decode(params, tok[:, i], HYMBA_PROMPT + i,
                                     cache)
            ref_logits.append(lg)
        torch.cuda.synchronize()
        if any(_build.launch_counts().values()):
            raise SystemExit("hymba: the plain path launched a kernel")
    rel_rms, max_abs, agree = [], [], []
    for a, b in zip(logits, ref_logits):
        d = (a - b).double()
        rel_rms.append(float(d.pow(2).mean().sqrt()
                             / b.double().pow(2).mean().sqrt()))
        max_abs.append(float(d.abs().max()))
        agree.append(float((a.argmax(-1) == b.argmax(-1)).double().mean()))
    if max(rel_rms) > HYMBA_LOGITS_RTOL:
        raise SystemExit(f"hymba: logits {max(rel_rms)} (relative RMS) from "
                         f"the plain path, above {HYMBA_LOGITS_RTOL}")
    decode_ms = trace["decode_ms"]
    summary = {
        "phase": "serve (hymba-1.5b)", "arch": cfg.name,
        "params": n_params, "param_count": cfg.param_count(),
        "dtype": cfg.dtype, "batch": HYMBA_BATCH, "prompt": HYMBA_PROMPT,
        "gen_tokens": HYMBA_GEN, "init_s": init_s,
        "prefill_ms": trace["prefill_ms"],
        "prefill_tokens_per_s": HYMBA_BATCH * HYMBA_PROMPT
        / trace["prefill_ms"] * 1e3,
        "decode_ms_per_token": float(np.median(decode_ms)),
        "decode_ms_steps": decode_ms,
        "decode_tokens_per_s": HYMBA_BATCH * len(decode_ms)
        / sum(decode_ms) * 1e3,
        "wall_s": wall_s,
        "served_tokens_per_s": HYMBA_BATCH * HYMBA_GEN / wall_s,
        "peak_memory_GB": peak / 1e9,
        "launches_prefill": {k: pre[k] for k in MODEL_PATH_KERNELS},
        "launches_decode": {k: dec[k] for k in MODEL_PATH_KERNELS},
        "logits_rel_rms_vs_plain": rel_rms, "logits_rel_rms_max": max(rel_rms),
        "logits_rtol": HYMBA_LOGITS_RTOL, "logits_max_abs_diff": max_abs,
        "greedy_agreement": agree,
        "greedy_agreement_mean": float(np.mean(agree)),
        "tokens_first_row": tokens[0].tolist(),
    }
    del params, cache, logits, ref_logits
    torch.cuda.empty_cache()
    return total, sizes, summary


def model_case(name: str, shape: tuple, dtype: torch.dtype,
               rng: np.random.Generator, size: str, *, window=None,
               pos0: int = 0, check_only: bool = False,
               misaligned: bool = False) -> dict:
    """Check one model kernel against its plain version on the card at a
    path shape (rope_3d bit for bit, its tables from position ``pos0``;
    the others within ``torch_bounds``; ``rmsnorm_2d``'s and ``rope_3d``'s
    x one element off 16-byte alignment if ``misaligned``), then time it
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
        t = s
        q, k, v = randn(bhq, s, d), randn(bhkv, t, d), randn(bhkv, t, d)
        scale = d ** -0.5
        run = lambda: fa_k.flash_attention_3d(        # noqa: E731
            q, k, v, scale=scale, causal=True, window=window)
        plain = lambda: fa_ref.flash_attention(        # noqa: E731
            q, k, v, scale=scale, causal=True, window=window)
        b = HYMBA_BATCH if bhq % HYMBA_BATCH == 0 else 1
        q4 = q.view(b, bhq // b, s, d)
        k4, v4 = k.view(b, bhkv // b, t, d), v.view(b, bhkv // b, t, d)
        qp, kp = torch.arange(s, device=dev), torch.arange(t, device=dev)
        mask = kp[None, :] <= qp[:, None]
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

    t0 = time.perf_counter()
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
    hymba_counts, hymba_sizes, summary = hymba_phase()
    emit(summary)

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
    rows_n = HYMBA_BATCH * HYMBA_PROMPT
    vecadd_hymba = eager_case("vecadd_2d", (rows_n, 1600), bf16, rng,
                              "hymba prefill residual add")
    eager_case("vecadd_2d", (HYMBA_BATCH, 1600), bf16, rng,
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
            ((HYMBA_BATCH, 1600), bf16, "column, M = 4", ()),
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
    last = HYMBA_PROMPT + HYMBA_GEN - 1
    # rmsnorm.cu's scalar kernel (x off 16-byte alignment; rows of 33 or
    # 100 values, no multiple of 16 bytes) and both kernels at M = 1
    for shape, dtype, size, off in (
            ((rows_n, 1600), bf16, "prefill shape, off alignment", True),
            ((HYMBA_BATCH, 3200), f32, "decode SSM shape, off alignment",
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
    for shape, size, off in (((20, HYMBA_PROMPT, 20), "D = 20", False),
                             ((100, HYMBA_PROMPT, 64),
                              "prefill q, off alignment", True),
                             ((20, 1, 64), "decode k, off alignment", True)):
        model_case("rope_3d", shape, bf16, rng, size, check_only=True,
                   misaligned=off)
    rope_decode = {}
    for name, shape, dtype, size, window, pos0, only in (
            ("rmsnorm_2d", (HYMBA_BATCH, 3200), f32,
             "decode SSM gated norm", None, 0, True),
            ("rmsnorm_2d", (rows_n, 3200), f32, "SSM gated norm", None, 0,
             False),
            ("rmsnorm_2d", (HYMBA_BATCH, 1600), bf16, "decode", None, 0,
             False),
            ("rmsnorm_2d", (rows_n, 1600), bf16, "prefill", None, 0, False),
            ("rope_3d", (20, 1, 64), bf16, "decode k", None, last, False),
            ("rope_3d", (100, 1, 64), bf16, "decode q", None, last, False),
            ("rope_3d", (20, HYMBA_PROMPT, 64), bf16, "prefill k", None, 0,
             False),
            ("rope_3d", (100, HYMBA_PROMPT, 64), bf16, "prefill q", None, 0,
             False),
            ("flash_attention_3d", (100, 20, 2000, 64), bf16,
             "prompt 2000, window edge inside a tile", 1000, 0, True),
            ("flash_attention_3d", (100, 20, 2000, 64), bf16,
             "prompt 2000", 1024, 0, True),
            ("flash_attention_3d", (100, 20, HYMBA_PROMPT, 64), bf16,
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
    # every size the serve launched a kernel with was checked above
    checked = _build.launch_sizes()
    for name in MODEL_PATH_KERNELS:
        missed = hymba_sizes[name] - checked[name]
        if missed:
            raise SystemExit(f"{name}: the hymba serve launched it with sizes "
                             f"{sorted(missed)}, which no check held against "
                             f"its plain version")
    emit({"phase": "hymba shapes checked",
          "sizes": {k: sorted(hymba_sizes[k]) for k in MODEL_PATH_KERNELS}})
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
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
