"""Chip smoke test of the PyTorch port: AlexNet-DAU, the CIFAR nets and
DAU-ResNet-18, serving and training on one NVIDIA GPU, directly, through
the example scripts and through the sharded step.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository, on a machine with a CUDA card. Phases:

1. build: compile the nine kernel libraries for sm_90a, one nvcc each, all
   at once (K5 the fused forward, K4 the aggregation, K6 the grad tables,
   K1/K2 and K8 the fused spectral gradients, one kernel under two gather
   policies, K7 the partial iDFT, K3 the fused apply-phi; the probes' GEMM,
   gather and stream kernels), and print their
   registers and spills (ks=9; K1 and K8 at every (dtype, M, G) instance,
   failing if K1 spills at M=3, G=2 or K8 at any instance; K6's two
   instances, failing if either spills; K2's dx kernel
   and K3's products kernel, which share a mainloop, at every instance,
   failing if the bf16 G=2 one of either spills); count the
   tensor-core instructions (HGMMA, HMMA) and TMA loads (UTMALDG) in the
   SASS of the K5, K4, K6, K7, K1/K2/K8 and K3 libraries (`cuobjdump -sass`)
   and fail if any has none of either, and the HGMMA of each K8 instance,
   failing if one has none, and the HGMMA and UTMALDG of each instance of
   K2's dx kernel (`spectral_dx_kernel`) and of K3's products kernel
   (`apply_phi_gemm_kernel`; the B operand of both comes by TMA), failing if
   one has none of either, and of each instance of the probe GEMM (A
   K-major and M-major), failing if one has no HGMMA or no UTMALDG;
2. kernel vs twin: `dau_forward_fused` against `dau_forward_fused_plain` at
   the four AlexNet-DAU layer shapes (N=4) in f32 (TF32 off, bound
   1e-4*max|y|) and bf16 (twin in f32 on the same bf16 values, bound
   1e-2*max|y|, about one bf16 rounding of the output), plus an edge case
   with mu at +-max_offset and at integers;
3. serving: the default-variant AlexNet-DAU in bf16 with engine
   'pallas_fused', random weights from --seed, answers 3 requests of 32
   images at 3x227x227; the kernel's launch count must rise by 4 (one per
   DAU layer) per request and the logits must be finite;
4. reference: the same weights in f32, through the kernel and through the
   plain twins, must agree within 1e-3*max|logits|;
5. timing: CUDA-event times of each layer's kernel (its operand building
   timed apart) and twin at N=32, beside the two-call library chain (a bf16
   depthwise `conv2d` blur with groups=S, then a bf16 `conv2d` with the
   synthesized K, synthesized beforehand), the 4*G-tap bound and the dense
   ks^2-tap GEMM at the bf16 peak; and of a whole request through either,
   beside the card's name and power limit;
6. backward kernels vs twins at the four layer shapes (N=4), f32 and bf16:
   K6 with M=3 (bound 1e-4*max|table| in both: bf16 products are exact in
   f32, so only the order of the f32 sums differs; f32 input goes through
   the three-way bf16 split, ~2^-24 of each product), K4 at the four forward
   and the four transposed dx shapes (f32 1e-4*max|y|: the three-way bf16
   split and the order of the f32 sums; bf16 1e-2*max|y|: one rounding of the
   output), and K5 at the four dx shapes with the mirrored 'error' filter;
7. training: the default-variant AlexNet-DAU in bf16 takes 3 SGD steps
   (lr 1e-4) on batches of 32 images at 3x227x227 through
   `make_train_step`, first with engine 'pallas_fused' (8 K5 + 4 K6
   launches per step), then with 'pallas' (8 K4 + 4 K6 per step); per step
   the loss must be finite, every trainable parameter must get a finite
   nonzero gradient and take the SGD update (old - lr*grad, rounded once to
   its dtype, within two ulps); every step here and in phases 12-26 runs
   eager (`cuda_graph=False`): phases 13 and 18 time them again under the
   plain twins, and their launches reach the kernels line; phase 28 holds
   the replayed step;
8. reference: one f32 step from the same weights, through the kernels and
   through the plain twins, per engine: every parameter's gradient must
   agree within 1e-3*max|grad| of that tensor;
9. timing: per-layer K6, K4 (forward and dx shapes) and dx-shape K5
   against their twins (and, where one PyTorch call computes the same
   function, that call; for K5 the two-call chain of phase 5) at N=32 bf16; K6 summed over the layers and K4
   over the 8 launches of a `pallas` step, each with its wrapper's operand
   building (K4: synthesis and layout) timed apart, and K4 beside both its
   bounds: the 4*G-tap work its inputs need and the dense 81-tap GEMM it
   executes, at the bf16 peak;
10. K1/K2 vs twin: `fused_spectral_grads` without and with the dx operands
   against `fused_spectral_grads_plain` at the four layer shapes (N=4;
   conv2's 496 bins are forced, the op sends conv2 to the unfused gather)
   in f32 (TF32 off, bound 1e-4*max|ref|: f32 sums in another order) and
   bf16 (bound 1e-2*max|ref|: the cross-spectra are rounded to bf16 in
   both, and a sum on the other side of a rounding boundary moves one term
   by a bf16 ulp);
11. Fourier serving: the default-variant AlexNet-DAU in bf16 with engine
   'auto' (-> 'fourier') answers 3 requests of 32x3x227x227 with no kernel
   launch; then with phi_caching after `refresh_phi_cache`, whose logits
   must match the uncached ones within 1e-2*max|logits| (one bf16 rounding;
   the same table is built either way, so 0 is expected);
12. Fourier training: 3 bf16 SGD steps through `make_train_step` with the
   checks of phase 7, with defaults (3 K1 launches per step: conv3-conv5;
   conv2's 496 bins take the unfused gather) and with fused_dx='on' (3 K2
   per step); then one f32 step with engine 'fourier' and fused_bwd='on'
   (K1 at all four layers), and again with fused_dx='on', through the
   kernels and through the twins: every gradient within 1e-3*max|grad|;
13. timing: per layer K1 and K2 against their twins (checked against them
   first at N=32 in bf16, bounds as in phase 10; K1 also as device time,
   the kernel alone and with its wrapper's torch ops, `torch.profiler`;
   conv2's 496 bins forced) and the unfused torch path
   (`fourier_unit_grads`), whole bf16 requests (Fourier uncached,
   phi-cached, pallas_fused) and whole bf16 steps (Fourier, Fourier with
   fused_dx, both Pallas engines), the device time by kernel of both
   Pallas steps and both Fourier steps (`torch.profiler`) and the Fourier
   step's peak memory; per layer and over conv3-conv5 (K2's 3 launches), K2's
   dx kernel alone: its device time, its bytes bound, its plain twin
   (`_dx_spectra_plain` on prebuilt phase factors) and one bf16 `torch.bmm`
   of (B, 2N, 2F) . (B, 2F, S) on prebuilt operands (the contraction alone,
   V built beforehand);
14. K8 vs twin: `fused_spectral_grads(gather="factored")` without and with
   the dx operands against `fused_factored_grads_plain` at the four layer
   shapes (N=4), bounds as in phase 10;
15. factored training: 3 bf16 SGD steps with fused_gather='factored' (4 K8
   launches per step, conv2 included: the factored gate has no bin
   threshold), then 3 with fused_dx='on' as well (4 K8 dx), with the checks
   of phase 7; one f32 step of each through the kernels and through the
   twins (every gradient within 1e-3*max|grad|), whose gradients must also
   agree with the f32 fused_bwd='on' phi-gather step's of phase 12;
16. K7 vs twin at the four layers' cross-spectra (N=4, M=3), f32 (bound
   1e-4*max|ref|) and bf16 (the table rounded once to bf16: 1e-2), and at
   K3's closing operands (P = 169 and 729 positions, f32 spectra of N=4
   images, 1e-4); the
   'pmsf' gather of `fourier_grad_tables` against `fourier_unit_grads`,
   f32 within K1's 1e-4 and bf16 within 2e-2 (the two gathers round at
   different places in bf16: the table, the mask and their product against
   T and the phase products); then the path `fourier_grad_tables` +
   `tap_gather(..., 'pmsf')` at the four layers (N=32, bf16), 4 K7 launches;
17. K3 vs twin, forward and contract_f, at the four layers (N=4), f32
   (1e-4*max|ref|) and bf16 (1e-2); `fourier_apply_phi_fused` against
   `fourier_forward` and `fourier_input_grad` within 1e-4 (f32) / 1e-2
   (bf16) * max|y|; K3 at ks 33 and 65 (36 and 68 exponents) on a small
   plane (N=4, S=16, F=24, 7x7) against its twin in both directions and
   dtypes, bounds as above; then the path `fourier_apply_phi_fused` in both
   directions at the four layers (N=32, bf16), 8 K3 calls;
18. timing: per layer at N=32 bf16, K8 and K8 dx against their twin, K1
   and the unfused torch path, and K8's device time (`torch.profiler`: the
   kernel alone, and with its operand kernel and sum), also summed over the
   layers; the dx kernel as in phase 13 at the four layers (K8 dx's 4
   launches); K7 against its twin and one bf16 matmul of the stacked operands,
   also summed over the layers; K3 against its twin and the unfused chain,
   its closing launch (the split of f32 Y and K7's kernel) alone, its
   device time (`torch.profiler`: the products kernel, the operand
   building, the closing launch, the whole call) and one bf16 `torch.bmm`
   of its per-bin products alone (Phi built beforehand), also summed over
   the layers and directions; K4's and K5's
   kernels alone at ks=9 (device time over the 8 launches of a step, forward
   and dx shapes); the factored steps (and the phi-gather Fourier step
   beside them) as medians of 5 runs with min and max, and the device time
   by kernel of the factored step;
19. K4 and K5 past ks 17, the kernel tiers 33 and 65, whose staged windows
   hold bands of tap rows: both against their twins at ks=33 at the four
   layer shapes and their dx shapes (N=4, f32 1e-4*max|y|, bf16
   1e-2*max|y|, as in phase 6); their times at ks 33 and 65 (N=32 bf16,
   forward and dx shapes, with the wrapper and as device time); then 3 bf16
   SGD steps at max_kernel_size=33 on 'pallas' (8 K4 + 4 K6 per step) and on
   'pallas_fused' (8 K5 + 4 K6), with the checks of phase 7;
20. planes wider than a TMA box side (256 pixels), which K4 and K5 cut into
   column strips: both against their twins at W = 300 and 640 (H = 5, N=2,
   S=9, F=70; ks 3, 9 and 33; f32 1e-4*max|y|, bf16 1e-2*max|y|); their
   times at N=8, S=64, F=128, ks 9 on 24x300 and 24x640 beside a plane of
   the same pixel count with one strip (48x150, 96x160); then one SGD step
   each on 'pallas' and 'pallas_fused' of a small net (conv, two DAU layers,
   pool, linear) on 2x32x24x300, its launch counts (2 forward + 2 dx K4 or
   K5, 2 K6), a finite loss and finite gradients;
21. the CIFAR nets from the repo's trained artifacts, f32, eval mode:
   `docs/spatial_dau_4000_params.npz` in DAUCifarNet (G = 4) through the
   engines 'xla' (cuDNN, TF32 off), 'pallas' (3 K4 per request),
   'pallas_fused' (3 K5) and 'fourier', and `docs/spatial_conv_2500_params.npz`
   in ConvCifarNet (plain torch ops), on the recorded test slice (the first
   500 test images of `synthetic_spatial(n=50000)`) in requests of 125:
   each engine's logits within 1e-3*max|logits| of its plain twins' and of
   the 'xla' engine's, top-1 in [0.42, 0.58] and pair accuracy >= 0.92,
   and the request times;
22. CIFAR training in bf16: 3 SGD steps (lr 1e-3) of 128 training images
   of the same task per run, with the checks of phase 7 and moving
   BatchNorm statistics: 'auto' (-> fourier; 3 K1 per step at G = 4, one
   per layer), 'pallas_fused' (3 forward + 2 dx K5 and 3 K6: conv1's input
   is the image, so it runs no dx pass), 'pallas' (3 + 2 K4, 3 K6), and
   with a trainable sigma (blur 17x17, M = 4) 'auto' and 'pallas_fused';
   then one more bf16 step per run with every kernel launch held against
   its plain twin on the same inputs (`checked_kernels`: K5, K4 and K1
   within 1e-2*max|twin|, K6 within 1e-4); one f32 step per engine
   ('fourier', 'pallas_fused', 'pallas', and the two trainable-sigma
   runs) through the kernels and the twins, every
   gradient within 1e-3*max|grad|; step times and the device time by kernel
   class of the 'auto' and 'pallas_fused' steps;
23. DAU-ResNet-18 at full width (64, G = 4, 1,000 classes) in bf16 on
   32x3x224x224: 3 requests on 'pallas_fused' (16 K5 per request, planes
   56x56 down to 7x7; F = 64 takes K5's branch without a cluster) and on
   'auto' (-> fourier, none), 3 SGD steps (lr 1e-4) on 'auto' (16 K1 per
   step) and on 'pallas_fused' (16 forward + 16 dx K5, 16 K6) with the
   checks of phase 22 (one request on 'pallas_fused' and one step per run
   under `checked_kernels`); request and step times (median of 5 with min
   and max) and the device time by kernel class of each step; then per
   layer shape of the CIFAR nets (N=128) and of one layer per ResNet stage
   (N=32), G = 4, bf16: K5 (kb 9, and 17 at the CIFAR layers), K4, K6 and
   K1 checked against their twins on the same inputs, then timed: K5
   against its twin and the two-call library chain, K4 and K6 against one
   `conv2d` each, K1 against its twin;
24. the bench's configurations (`dau_convnet_tpu_torch/bench.py`), bf16:
   one SGD step of the small variant (units (1, 1), rounded to G = 2 with
   one dummy unit) and of the large one (G = 4) on 'auto' (-> fourier: 3
   K1 for small as for default, 4 for large, whose G >= 4 gate takes
   conv2's 496 bins too) and on 'pallas_fused' (8 K5 + 4 K6), each under
   `checked_kernels` with `run_steps`' checks; one phi-cached request of
   each variant against its uncached request (1e-2*max|logits|); 20
   memtest steps (`bench.memtest_setup`: 6x6 planes, S=128, F=256, mu
   from +-10 clipped to 3.9; one K1 a step at 60 bins), the first under
   `checked_kernels`, all finite; the layer cell (`bench.layer_setup`:
   N32, S128, 16x16, F32, G=2) on 'pallas' (2 K4 + 1 K6), 'pallas_fused'
   (2 K5 + 1 K6) and 'fourier' (1 K1) at static_max_offset 3 and 1 (ks 9
   and 5), each step under `checked_kernels`; and `python -m
   dau_convnet_tpu_torch.bench --model layer --iters 5` as a child
   process, whose last line must carry a value. Each step's device ms of
   K5, K4, K6 and K1 and of everything (torch.profiler) is printed;
25. the examples (`dau_convnet_tpu_torch/examples/`), called in process
   but analyze_spatial: one step of each trainer through its step builder
   under `checked_kernels` (train_alexnet_synth's `make_step`, small
   variant bf16, 3 K1; train_cifar10's `make_train_step`, f32 fourier, 3
   K1); then train_alexnet_synth at its defaults (1,000 bf16 steps of 32
   images at 3x227x227, 64 classes, Adam 3e-4, chunks of 50, a checkpoint
   and resume mid-run): every loss finite, the last-20 mean below 0.1x the
   first-20, the resume delta 0.0, max|mu| <= 3.99, 3 K1 a step;
   train_cifar10 on the spatial task (f32, fourier, batch 128, 600 steps,
   --auto-tier, evaluated at 300 and 600): every loss finite, the health
   check passing, test top-1 >= 0.40, 3 K1 a step, its saved params scoring
   the same top-1; serve_inference (torch.export round trip of DAUCifarNet
   below 1e-5 on 'xla' and 'fourier', 50 chained requests, no launch); and
   `python -m dau_convnet_tpu_torch.examples.analyze_spatial` on
   `docs/spatial_dau_4000_params.npz` as a child process, its first 500
   predictions equal to phase 21's 'fourier' argmax but where phase 21's
   two largest logits lie within 1e-3*max|logits|.

26. the parallel slice (`dau_convnet_tpu_torch/parallel/`): AlexNet-DAU
   (default variant, G = 2, full width, N = 32 global, bf16, 'auto' ->
   fourier, fused_dx='on') through the sharded step on the meshes 2x1
   (data) and 1x2 (model), two processes on the one card over gloo, and
   1x1, one process over nccl: per rank 3 SGD steps on its rows (from
   `prefetch_to_device(..., sharding=batch_sharding(mesh))`), the first
   under `checked_kernels`, 3 K2 launches a step (conv3-conv5, on the
   shard's N and F), losses finite and within 1e-2 of the one-process
   step's; the step's time beside the one-process step's and the time in
   its collectives; one f32 step whose loss (1e-5 relative) and gathered
   parameters (two ulps + LR * 1e-3 * max|grad|) match the one-process f32
   step's from the same weights.

27. the probes (`dau_convnet_tpu_torch/probes/`): P1-P7 through
   `mosaic_probe.run()` and P8-P9 through `pallas_ladder.run()`, the entry
   points of `python -m dau_convnet_tpu_torch.probes.mosaic_probe` and
   `.pallas_ladder`, at the JAX probes' full shapes with their seeded
   inputs: each probe kernel against its twin (the probe GEMM of P1, P2,
   P5, P6 within 1e-4*max|twin|; P3, P4, P7, P8 exactly; P9, K7's kernel,
   within 1e-2*max|twin|) and, per probe, its time (CUDA events, median,
   min and max of 5 runs of 10), the padding or chunk cutting apart, the
   bound, the twin and one PyTorch call of the function (P1 `matmul`, P2
   `einsum`, P5/P6 `bmm`, P8 `Tensor.copy_`, P9 one bf16 matmul of the
   stacked operands; P3, P4, P7 the twin); P3 at 24, 40 and 60 MB beside
   the card's opt-in shared memory and L2; P4's cost of one launch; P8's
   copy rate. Each of the six wrappers (probe GEMM, gather, the three
   stream kernels, K7) must launch in the phase's run.

28. the one-device step replayed as one CUDA graph (`make_train_step`'s
   default on the card): per run of GRAPH_RUNS, AlexNet-DAU (default
   variant, bf16, N=32) takes 3 SGD steps from the seed's weights eager,
   twice, and through the graphed step (the first call eager, the second
   captures and replays, the third replays): the graphed losses,
   parameters, gradients and BatchNorm statistics must equal the first
   eager run's bit for bit where the second eager run does, else lie
   within its distance; then one more eager and one more replayed step,
   each under `torch.profiler`: the hand kernels' launches read from the
   replay's trace must equal those of the eager step's trace and those
   its launch counters counted (taken again, up to 3 times, where a trace
   is partial), and each device event whose count differs between the two
   traces is printed; the eager and the replayed step's times (CUDA
   events, 5 runs of 3).

The whole run's time prints before the summary. The second-to-last line
is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import dau_convnet_tpu_torch  # noqa: E402
from dau_convnet_tpu_torch.kernels import backward as kbwd  # noqa: E402
from dau_convnet_tpu_torch.kernels import forward as kfwd  # noqa: E402
from dau_convnet_tpu_torch.kernels import fused_bwd as kfb  # noqa: E402
from dau_convnet_tpu_torch.kernels import fused_fwd as kff  # noqa: E402
from dau_convnet_tpu_torch.kernels import spectral as ksp  # noqa: E402
from dau_convnet_tpu_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from dau_convnet_tpu_torch import bench  # noqa: E402
from dau_convnet_tpu_torch.kernels._build import build, build_log, disassemble  # noqa: E402
from dau_convnet_tpu_torch.examples import analyze_spatial as az  # noqa: E402
from dau_convnet_tpu_torch.examples import serve_inference as si  # noqa: E402
from dau_convnet_tpu_torch.examples import train_alexnet_synth as ta  # noqa: E402
from dau_convnet_tpu_torch.examples import train_cifar10 as tc  # noqa: E402
from dau_convnet_tpu_torch.examples.train_cifar10 import synthetic_spatial  # noqa: E402
from dau_convnet_tpu_torch.models import (AlexNetDAU, ConvCifarNet, DAUCifarNet,  # noqa: E402
                                          DAUResNet)
from dau_convnet_tpu_torch.nn import DAUConv2d, refresh_phi_cache  # noqa: E402
from dau_convnet_tpu_torch.ops import DAUConvSettings, gaussian_filters  # noqa: E402
from dau_convnet_tpu_torch.ops import fourier_engine as fe  # noqa: E402
from dau_convnet_tpu_torch.ops import xla_engine  # noqa: E402
from dau_convnet_tpu_torch.data import prefetch_to_device  # noqa: E402
from dau_convnet_tpu_torch.parallel import (batch_sharding, gather_state,  # noqa: E402
                                            init_sharded, make_mesh, make_train_step)
from dau_convnet_tpu_torch.parallel import _collectives  # noqa: E402
from dau_convnet_tpu_torch.parallel._spawn import run_ranks  # noqa: E402
from dau_convnet_tpu_torch import probes as probes_pkg  # noqa: E402
from dau_convnet_tpu_torch.probes import mosaic_probe, pallas_ladder  # noqa: E402
from dau_convnet_tpu_torch.utils import load_params_npz, params_from_flax  # noqa: E402
from dau_convnet_tpu_torch.utils.profiling import (device_busy_ms, device_time,  # noqa: E402
                                                    kernel_ms, trace)

KERNEL = dict(name="dau_forward_fused (K5: blur warps + TMA + wgmma)", route="cuda",
              source="dau_convnet_tpu_torch/kernels/csrc/dau_forward_fused.cu",
              replaces="dau_convnet_tpu/kernels/forward.py:266")
KERNEL_K6 = dict(name="grad_tables", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_grad_tables.cu",
                 replaces="dau_convnet_tpu/kernels/backward.py:123")
KERNEL_K4 = dict(name="aggregate_forward", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_aggregate.cu",
                 replaces="dau_convnet_tpu/kernels/forward.py:111")
KERNEL_K1 = dict(name="fused_spectral_grads (K1)", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_spectral_grads.cu",
                 replaces="dau_convnet_tpu/kernels/fused_bwd.py:965")
KERNEL_K2 = dict(KERNEL_K1, name="fused_spectral_grads with dx (K2)")
KERNEL_K8 = dict(name="fused_spectral_grads gather=factored (K8)", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_spectral_grads.cu",
                 replaces="dau_convnet_tpu/kernels/fused_bwd.py:763")
KERNEL_K8_DX = dict(KERNEL_K8, name="fused_spectral_grads gather=factored with dx (K8 dx)")
KERNEL_DX = dict(KERNEL_K1, name="spectral_dx_kernel (K2's and K8 dx's dx contraction: TMA + "
                 "wgmma)")
KERNEL_K7 = dict(name="partial_idft (K7)", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_partial_idft.cu",
                 replaces="dau_convnet_tpu/kernels/spectral.py:73")
KERNEL_K3 = dict(name="fused_apply_phi (K3)", route="cuda",
                 source="dau_convnet_tpu_torch/kernels/csrc/dau_apply_phi.cu",
                 replaces="dau_convnet_tpu/kernels/fused_fwd.py:225")
# the name fragment of K3's products kernel (its device time in phase 18)
K3_PRODUCTS = "apply_phi_gemm_kernel"
LIBRARIES = ("dau_forward_fused", "dau_aggregate", "dau_grad_tables", "dau_spectral_grads",
             "dau_partial_idft", "dau_apply_phi", "dau_probe_gemm", "dau_probe_gather",
             "dau_probe_stream")
# the card's peaks for the bounds (H100 SXM data sheet, dense, at 700 W):
# bf16 on the tensor cores and the memory rate
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
# (name, S, F, H=W) of the AlexNet-DAU DAU layers at 227x227 input
LAYERS = (("conv2", 96, 256, 27), ("conv3", 256, 384, 13),
          ("conv4", 384, 384, 13), ("conv5", 384, 256, 13))
G = 2
BATCH, IMAGE, REQUESTS = 32, 227, 3
STEPS, LR, M = 3, 1e-4, 3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def _cuda_ms(fn, iters: int = 10) -> float:
    """ms per call of fn: `device_time`'s CUDA events after a warm-up."""
    return device_time(fn, iters=iters) * 1e3


def _kernel_ms(fn, iters: int = 5):
    """`kernel_ms` per call of fn: a device-only `trace` of `iters` calls
    after one warm-up, taken again (up to 3 times) where it recorded no
    device time at all."""
    fn()
    for _ in range(3):
        with trace(host=False) as prof:
            for _ in range(iters):
                fn()
        rows = kernel_ms(prof)
        if rows:
            break
    return {key: ms / iters for key, ms in rows.items()}


def _device_ms(fn, fragment: str, iters: int = 5):
    """(device ms of the kernels whose name holds `fragment`, device ms of
    all kernels) per call of fn, from `_kernel_ms`."""
    rows = _kernel_ms(fn, iters)
    return sum(ms for k, ms in rows.items() if fragment in k), sum(rows.values())


# the name fragments of K5's, K4's, K6's and K1's kernels in a profile
KERNEL_NAMES = (("K5", "fused_forward_kernel"), ("K4", "aggregate_kernel"),
                ("K6", "grad_tables_kernel"), ("K1", "spectral_grads_kernel"))


def _kernel_line(fn, iters: int = 3) -> str:
    """Device ms per call of fn of each of K5, K4, K6 and K1 that ran, and
    of everything on the device."""
    rows = _kernel_ms(fn, iters)
    parts = [f"{k} {sum(ms for n, ms in rows.items() if frag in n):.4f}"
             for k, frag in KERNEL_NAMES if any(frag in n for n in rows)]
    return f"device ms per step: {', '.join(parts)}; all {sum(rows.values()):.4f}"


def _spread(fn, repeats: int = 5, iters: int = 5):
    """(median, min, max) ms of `repeats` runs of `iters` calls of fn (the
    bench's `time_steps`): the Fourier paths launch many small ops, so the
    host sets their pace and a single mean moves from run to run."""
    med, runs = bench.time_steps(fn, iters, torch.device("cuda"), repeats)
    return med * 1e3, min(runs), max(runs)


def _fmt(spread) -> str:
    med, lo, hi = spread
    return f"{med:.3f} ms (min {lo:.3f}, max {hi:.3f})"


def _layer_inputs(gen, n, s, f, hw, dtype, dev, mu=None):
    x = torch.rand((n, s, hw, hw), generator=gen).to(dev, dtype)
    w = (torch.randn((s, G, f), generator=gen) * 0.1).to(dev, dtype)
    if mu is None:
        mu1, mu2 = (torch.rand((2, s, G, f), generator=gen) * 7.98 - 3.99).to(dev, dtype)
    else:
        idx = torch.randint(0, len(mu), (2, s, G, f), generator=gen)
        mu1, mu2 = torch.tensor(mu)[idx].to(dev, dtype)
    return x, w, mu1, mu2


def compare(gen, dev, filt, ks):
    """Kernel vs twin at each layer shape; returns the largest |error|."""
    worst = 0.0
    edge = DAUConvSettings().max_offset
    cases = [(name, s, f, hw, None) for name, s, f, hw in LAYERS]
    cases.append(("conv2-edge-mu", 96, 256, 27, [-edge, edge, -3.0, 0.0, 1.0, 3.0]))
    for name, s, f, hw, mu in cases:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x, w, mu1, mu2 = _layer_inputs(gen, 4, s, f, hw, dtype, dev, mu)
            y = kfwd.dau_forward_fused(x, w, mu1, mu2, filt, ks)
            want = kfwd.dau_forward_fused_plain(x.float(), w, mu1, mu2, filt, ks)
            torch.cuda.synchronize()
            if y.dtype != dtype or y.shape != want.shape:
                raise AssertionError(f"{name}: got {y.dtype} {tuple(y.shape)}")
            err = float((y.float() - want).abs().max())
            scale = float(want.abs().max())
            print(f"compare {name} {str(dtype)[6:]}: max|err|={err:.3e} "
                  f"max|y|={scale:.3e} bound={bound * scale:.3e}")
            if not err <= bound * scale:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with the twin")
            worst = max(worst, err)
    return worst


def _spectral_twin(*args, gather="phi", **kw):
    """The plain twin of `fused_spectral_grads` for the gather asked for."""
    twin = kfb.fused_factored_grads_plain if gather == "factored" else kfb.fused_spectral_grads_plain
    return twin(*args, **kw)


@contextlib.contextmanager
def plain_twin():
    """Route the kernel calls (K5, K4, K6, K1/K2/K8, K7, K3) to their plain
    twins (for timing and the reference runs); the launch counters are left
    alone."""
    routes = ((kfwd, "dau_forward_fused", kfwd.dau_forward_fused_plain),
              (kfwd, "aggregate_forward", kfwd.aggregate_forward_plain),
              (kbwd, "grad_tables", kbwd.grad_tables_plain),
              (kfb, "fused_spectral_grads", _spectral_twin),
              (ksp, "partial_idft", ksp.partial_idft_plain),
              (kff, "fused_apply_phi", kff.fused_apply_phi_plain))
    kernels = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, twin in routes:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for (mod, name, _), kernel in zip(routes, kernels):
            setattr(mod, name, kernel)


def _widen(args):
    return (args[0].float(), *args[1:])


# (module, wrapper, its twin, bound for f32 and bf16 input (None: the same
# for both), the twin takes f32 x) of each kernel `checked_kernels` holds;
# the bounds of phases 1, 6 and 10
_CHECKED = (("K5", kfwd, "dau_forward_fused", kfwd.dau_forward_fused_plain, (1e-4, 1e-2), True),
            ("K4", kfwd, "aggregate_forward", kfwd.aggregate_forward_plain, (1e-4, 1e-2), True),
            ("K6", kbwd, "grad_tables", kbwd.grad_tables_plain, (1e-4, 1e-4), False),
            ("K1/K2/K8", kfb, "fused_spectral_grads", _spectral_twin, (1e-4, 1e-2), False))


@contextlib.contextmanager
def checked_kernels(tag):
    """Hold every launch of K5, K4, K6 and K1/K2/K8 inside the block, at
    the shapes and on the inputs the path gives it, against its plain twin
    on the same inputs: each output within its bound (`_CHECKED`) times
    max|twin|. Prints the worst error of each kernel; raises after the
    block, naming every call that disagreed. The kernels' launches count as
    the path's; the twins launch nothing."""
    worst, failed = {}, []

    def checked(name, kernel, twin, bounds, widen):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            want = twin(*(_widen(args) if widen else args), **kw)
            torch.cuda.synchronize()
            bound = bounds[args[0].dtype == torch.bfloat16]
            for got, ref in zip(*((o if isinstance(o, tuple) else (o,)) for o in (out, want))):
                err = float((got.float() - ref.float()).abs().max())
                rel = err / max(float(ref.float().abs().max()), 1e-30)
                calls, top = worst.get(name, (0, 0.0))
                worst[name] = (calls + 1, max(top, rel))
                if got.shape != ref.shape or not rel <= bound:
                    failed.append(f"{name} {tuple(args[0].shape)} {args[0].dtype}: "
                                  f"max|err|/max|twin| = {rel:.3e}, bound {bound:.0e}")
            return out
        # the kernel's launch counters are attributes of the module's
        # function, which the wrapper counts through: share them
        call.__dict__ = kernel.__dict__
        return call

    kernels = [getattr(mod, attr) for _, mod, attr, *_ in _CHECKED]
    for (name, mod, attr, twin, bounds, widen), kernel in zip(_CHECKED, kernels):
        setattr(mod, attr, checked(name, kernel, twin, bounds, widen))
    try:
        yield
    finally:
        for (_, mod, attr, *_), kernel in zip(_CHECKED, kernels):
            setattr(mod, attr, kernel)
    print(f"checked {tag} against the twins: " + ("; ".join(
        f"{k} {n} outputs, worst max|err|/max|twin| {w:.3e}" for k, (n, w) in worst.items())
        or "no kernel launched"))
    if failed:
        raise AssertionError(f"{tag}: kernels disagree with their twins: " + "; ".join(failed))


def _tables_inputs(gen, n, s, f, hw, dtype, dev):
    """(M, N, S, H, W) view of a stacked blur, as the op hands it to K6, and
    an error of (N, F, H, W)."""
    xb = torch.randn((n, s * M, hw, hw), generator=gen).to(dev, dtype)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    return xb.reshape(n, s, M, hw, hw).permute(2, 0, 1, 3, 4), err


def _dx_inputs(gen, n, s, f, hw, dtype, dev):
    """The dx pass's K5 call: an error of F channels and the S<->F
    transposed (strided) params with negated offsets."""
    _, w, mu1, mu2 = _layer_inputs(gen, 1, s, f, 1, dtype, dev)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    return err, w.permute(2, 1, 0), -mu1.permute(2, 1, 0), -mu2.permute(2, 1, 0)


def _check_err(name, got, want, bound):
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"compare {name}: max|err|={err:.3e} max|ref|={scale:.3e} bound={bound * scale:.3e}")
    if not err <= bound * scale:
        raise AssertionError(f"{name}: kernel disagrees with the twin")
    return err


def compare_backward(gen, dev, ks):
    """K6, K4 (forward and dx shapes) and dx-shape K5 vs their twins at each
    layer shape (N=4); returns the largest |error| of each."""
    worst = {"k6": 0.0, "k4": 0.0, "k5dx": 0.0}
    error_filt = gaussian_filters(0.5, size=9, device=dev)["error"]
    for name, s, f, hw in LAYERS:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            tag = f"{name} {str(dtype)[6:]}"
            xb, err = _tables_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kbwd.grad_tables(xb, err, ks)
            worst["k6"] = max(worst["k6"], _check_err(
                f"K6 {tag} M={M}", got, kbwd.grad_tables_plain(xb, err, ks), 1e-4))
            x, w, mu1, mu2 = _layer_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kfwd.aggregate_forward(x, w, mu1, mu2, ks)
            if got.dtype != dtype:
                raise AssertionError(f"K4 {tag}: output is {got.dtype}")
            worst["k4"] = max(worst["k4"], _check_err(
                f"K4 {tag}", got, kfwd.aggregate_forward_plain(x.float(), w, mu1, mu2, ks),
                bound))
            e, wt, m1, m2 = _dx_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kfwd.aggregate_forward(e, wt, m1, m2, ks)
            if got.dtype != dtype:
                raise AssertionError(f"K4 dx {tag}: output is {got.dtype}")
            worst["k4"] = max(worst["k4"], _check_err(
                f"K4 dx {tag} {f}->{s}", got,
                kfwd.aggregate_forward_plain(e.float(), wt, m1, m2, ks), bound))
            got = kfwd.dau_forward_fused(e, wt, m1, m2, error_filt, ks)
            if got.dtype != dtype:
                raise AssertionError(f"K5 dx {tag}: output is {got.dtype}")
            want = kfwd.dau_forward_fused_plain(e.float(), wt, m1, m2, error_filt, ks)
            worst["k5dx"] = max(worst["k5dx"], _check_err(
                f"K5 dx {tag} {f}->{s}", got, want, bound))
    return worst


COUNTS = "(K5, K4, K6, K1, K2, K8, K8 dx, K7, K3)"
# (owner, attribute) of each launch counter, in COUNTS' order
_COUNTERS = tuple(LAUNCH_COUNTERS[k] for k in ("k5", "k4", "k6", "k1", "k2", "k8", "k8_dx",
                                                  "k7", "k3"))


def _counts():
    return tuple(getattr(owner, name) for owner, name in _COUNTERS)


def _zero_counts():
    for owner, name in _COUNTERS:
        setattr(owner, name, 0)


def _ulp(t, dtype):
    """One unit in the last place of each entry of t in `dtype` (f32 out)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       torch.frexp(t.float().abs()).exponent - bits)


# launches per bf16 step (COUNTS) and the model's settings, per run
TRAIN_RUNS = {
    "pallas_fused": (dict(engine="pallas_fused"), (8, 0, 4, 0, 0, 0, 0, 0, 0)),
    "pallas": (dict(engine="pallas"), (0, 8, 4, 0, 0, 0, 0, 0, 0)),
    "fourier": (dict(), (0, 0, 0, 3, 0, 0, 0, 0, 0)),
    "fourier fused_dx": (dict(fused_dx="on"), (0, 0, 0, 0, 3, 0, 0, 0, 0)),
    "fourier factored": (dict(fused_gather="factored"), (0, 0, 0, 0, 0, 4, 0, 0, 0)),
    "fourier factored fused_dx": (dict(fused_gather="factored", fused_dx="on"),
                                  (0, 0, 0, 0, 0, 0, 4, 0, 0)),
    "pallas ks33": (dict(engine="pallas", max_kernel_size=33), (0, 8, 4, 0, 0, 0, 0, 0, 0)),
    "pallas_fused ks33": (dict(engine="pallas_fused", max_kernel_size=33),
                          (8, 0, 4, 0, 0, 0, 0, 0, 0)),
}


def train(engine, dev, seed, batches, labels):
    """3 bf16 SGD steps of AlexNet-DAU through `make_train_step` for the run
    `engine` of TRAIN_RUNS, with `run_steps`' checks. Returns (model, step,
    launch counts, moved)."""
    kw, want = TRAIN_RUNS[engine]
    model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(seed), **kw)
    return (model, *run_steps(engine, model, [(x, labels) for x in batches], want, LR))


def _fixed_sigmas(model):
    """Names of the sigma parameters that do not train (a layer's fixed
    sigma is detached in its forward: no gradient, no update)."""
    return {f"{name}.sigma" for name, m in model.named_modules()
            if isinstance(m, DAUConv2d) and not m.dau_sigma_trainable}


def _stats(model):
    return {k: b.detach().clone() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def run_steps(tag, model, data, want, lr):
    """SGD steps of `model` through `make_train_step`, eager (its steps are
    timed again under `plain_twin()` and `checked_kernels`, which a replayed
    graph would bypass, and their launch counters reach the kernels line:
    phase 28 holds the replayed step), one per (x, labels) of `data`;
    checks the launch counts of each step against `want`, a finite loss, a
    finite nonzero gradient for every trainable parameter and its SGD
    update, and that every BatchNorm running statistic moved. Returns
    (step, launch counts, moved)."""
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr), cuda_graph=False)
    fixed = _fixed_sigmas(model)
    first = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = _stats(model)
    _zero_counts()
    for i, (x, labels) in enumerate(data):
        old = {k: p.detach().clone() for k, p in model.named_parameters()}
        before = _counts()
        loss = step(x, labels)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
        if got != want:
            raise AssertionError(f"{tag} step {i}: launches {COUNTS} {got}, want {want}")
        if not torch.isfinite(loss.float()):
            raise AssertionError(f"{tag} step {i}: loss {float(loss)}")
        for name, p in model.named_parameters():
            if name in fixed:
                if p.grad is not None or not torch.equal(p, old[name]):
                    raise AssertionError(f"{tag} step {i}: fixed sigma {name} moved")
                continue
            g = p.grad
            if g is None or not torch.isfinite(g.float()).all() or not torch.any(g != 0):
                raise AssertionError(f"{tag} step {i}: bad gradient for {name}")
            # one rounding of old - lr*grad to p's dtype, within two ulps (of
            # the larger of old and new): the add may be fused, and lr may be
            # rounded to p's dtype first
            sgd = (old[name].float() - lr * g.float()).to(p.dtype)
            tol = 2 * _ulp(torch.maximum(old[name].float().abs(), sgd.float().abs()), p.dtype)
            if not bool(((p.float() - sgd.float()).abs() <= tol).all()):
                raise AssertionError(f"{tag} step {i}: {name} did not take the SGD update")
        print(f"train {tag} step {i}: loss {float(loss):.5f}, launches {COUNTS} {got}")
    counts = _counts()
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, first[k])]
    still = [k for k, b in _stats(model).items() if torch.equal(b, stats[k])]
    if still:
        raise AssertionError(f"{tag}: BatchNorm statistics did not move: {still}")
    return step, counts, moved


def reference_step(engine, dev, seed, x, labels, **kw):
    """One f32 AlexNet-DAU step's gradients through the kernels and through
    the twins, from the same weights (`reference_grads`)."""
    model = AlexNetDAU(variant="default", image_size=IMAGE, engine=engine, dtype=torch.float32,
                       device=dev, generator=torch.Generator().manual_seed(seed), **kw)
    return reference_grads(f"{engine} {kw}", model, x, labels)


def reference_grads(tag, model, x, labels, backward_only=False):
    """One f32 step's gradients through the kernels and through the twins,
    from the same weights: every gradient within 1e-3*max|grad| of its
    tensor. With `backward_only` (the CIFAR nets) the twins' pass keeps the
    kernels' forward, so both backward passes start from the same bits:
    BatchNorm, ReLU and 2x2 max-pools turn the forward's last-bit
    differences into discrete ones (a near-tie broken the other way, a
    value near 0 on the other side of the ReLU), each moving one element's
    gradient far outside any rounding bound (§6 of PERF.md, PR 15); the
    forward kernels are held to their twins by phase 21's logits. Returns
    the worst error relative to its tensor's max|grad|, and the kernel
    path's gradients."""
    grads = []
    routes = ((contextlib.nullcontext, contextlib.nullcontext),
              (contextlib.nullcontext if backward_only else plain_twin, plain_twin))
    for forward, backward in routes:
        before = _counts()
        model.zero_grad(set_to_none=True)
        with forward():
            loss = torch.nn.functional.cross_entropy(model(x), labels)
        with backward():
            loss.backward()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_counts(), before))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
        if forward is contextlib.nullcontext and backward is contextlib.nullcontext:
            first = launched
    worst = 0.0
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"reference {tag}: {name} max|dg|={err:.3e} "
                                 f"max|g|={scale:.3e}")
    print(f"reference f32 step {tag}: loss {float(loss):.5f}; {len(grads[1])} "
          f"gradients, worst max|dg|/max|g| = {worst:.3e} (bound 1e-3); kernel-path "
          f"launches {COUNTS} {first}"
          + ("; the twins' pass on the kernels' forward" if backward_only else ""))
    return worst, grads[0]


def _bound(ops, nbytes):
    """(ms the card needs at least, which of the two sets it): operations
    over the bf16 tensor-core peak against bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class Bounds:
    """Sums per-layer bounds of one kernel over the layers it is timed at."""

    def __init__(self):
        self.ms, self.by = 0.0, {"operations": 0.0, "bytes": 0.0}

    def add(self, ops, nbytes):
        ms, by = _bound(ops, nbytes)
        self.ms += ms
        self.by[by] += ms
        return ms

    @property
    def bound_by(self):
        return max(self.by, key=self.by.get)


def _spectral_inputs(gen, n, s, f, hw, dtype, dev, g=G):
    """The fused kernel's operands at a layer shape, as the op makes them:
    the spectra of a stacked (M=3) blur and of an error, bilinear one-hots
    of random offsets, the phase tables; and the dx operands (blurred-error
    spectra, unit weights)."""
    p1, p2, rb = fe.plan_bins(hw, hw, 9)
    span = 5
    xb = torch.randn((M, n, s, hw, hw), generator=gen).to(dev, dtype)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    eb = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    xre, xim = fe._rdft2(xb, p1, p2, rb)
    xs = torch.cat([xre, xim], dim=1).permute(3, 0, 1, 2).contiguous()
    spectra = [torch.cat(fe._rdft2(e, p1, p2, rb), dim=0).permute(2, 0, 1).contiguous()
               for e in (err, eb)]
    mu1, mu2 = (torch.rand((2, s, g, f), generator=gen) * 7.98 - 3.99).to(dev, dtype)
    a1 = fe._phase_onehot(mu1, span, True).permute(0, 2, 1, 3)
    a2 = fe._phase_onehot(mu2, span, True).permute(0, 2, 1, 3)
    t1 = fe._phase_table(p1, p1, span, torch.float32, dev)
    t2 = fe._phase_table(p2, rb, span, torch.float32, dev, coef_p1=p1)
    wg = (torch.randn((g, s, f), generator=gen) * 0.1).to(dev, dtype)
    kw = dict(n_img=n, p1b=p1, rbb=rb)
    return (xs, spectra[0], t1, t2, a1, a2), kw, dict(esb=spectra[1], wg=wg), (xb, err, mu1, mu2)


def _spectral_work(args, kw, dx_args=None):
    """(operations, bytes) of one K1 call, or of a K2 call with dx_args:
    the per-bin cross products (8N per (k, m, s, f)), the gather (4G) and,
    for K2, the dx contraction (8N per (k, s, f)); each operand read once,
    each output written once."""
    xs, es, t1, t2, a1, a2 = args
    b, m, n2, s = xs.shape
    f, g = es.shape[2], a1.shape[1]
    ops = b * m * s * f * (4 * n2 + 4 * g)
    nbytes = _nbytes(*args) + m * s * g * f * 4
    if dx_args is not None:
        ops += 4 * n2 * b * s * f
        nbytes += _nbytes(dx_args["esb"], dx_args["wg"]) + b * n2 * s * 4
    return ops, nbytes


def compare_spectral(gen, dev, gather="phi"):
    """K1 and K2 (gather='phi'; phase 10) or K8 and K8 dx ('factored';
    phase 14) vs their twin at each layer shape (N=4; conv2's 496 bins
    included); returns the largest |error| of each."""
    keys, names = (("k1", "k2"), ("K1", "K2")) if gather == "phi" else (
        ("k8", "k8dx"), ("K8", "K8 dx"))
    worst = dict.fromkeys(keys, 0.0)
    for name, s, f, hw in LAYERS:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            tag = f"{name} {str(dtype)[6:]}"
            args, kw, dx, _ = _spectral_inputs(gen, 4, s, f, hw, dtype, dev)
            got = kfb.fused_spectral_grads(*args, **kw, gather=gather)
            want = _spectral_twin(*args, **kw, gather=gather)
            worst[keys[0]] = max(worst[keys[0]], _check_err(
                f"{names[0]} {tag} B={kw['p1b'] * kw['rbb']}", got, want, bound))
            got = kfb.fused_spectral_grads(*args, **kw, **dx, gather=gather)
            want = _spectral_twin(*args, **kw, **dx, gather=gather)
            err_dx = _check_err(f"{names[1]} dx spectra {tag}", got[1], want[1], bound)
            worst[keys[1]] = max(worst[keys[1]], err_dx,
                                 _check_err(f"{names[1]} grads {tag}", got[0], want[0], bound))
            worst["dx"] = max(worst.get("dx", 0.0), err_dx)
    return worst


def serve_fourier(dev, seed, requests, card):
    """Phase 11: bf16 default-engine serving, uncached and phi-cached.
    Returns the two models."""
    model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(seed))
    model.eval()
    engines = {getattr(model, f"dau_conv{i}").cfg.engine for i in range(2, 6)}
    if engines != {"fourier"}:
        raise AssertionError(f"bf16 engine 'auto' resolved to {engines}, not fourier")
    cached = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.bfloat16, device=dev, phi_caching=True,
                        generator=torch.Generator().manual_seed(seed))
    cached.eval()
    refresh_phi_cache(cached, requests[0])
    worst = scale = 0.0
    _zero_counts()
    with torch.inference_mode():
        for i, req in enumerate(requests):
            y = model(req)
            y_c = cached(req)
            torch.cuda.synchronize()
            for tag, logits in (("uncached", y), ("phi-cached", y_c)):
                if logits.shape != (BATCH, 1000) or not torch.isfinite(logits.float()).all():
                    raise AssertionError(f"fourier {tag} request {i}: bad logits")
            worst = max(worst, float((y.float() - y_c.float()).abs().max()))
            scale = max(scale, float(y.float().abs().max()))
    if any(_counts()):
        raise AssertionError(f"fourier serving launched kernels {COUNTS} {_counts()}")
    print(f"serving fourier: engine 'auto' -> fourier at all four DAU layers; {REQUESTS} "
          f"requests of {BATCH}x3x{IMAGE}x{IMAGE} bf16, logits finite, launches {COUNTS} "
          f"{_counts()}; phi-cached vs uncached max|dlogits|={worst:.3e} "
          f"max|logits|={scale:.3e} bound={1e-2 * scale:.3e}")
    if not worst <= 1e-2 * scale:
        raise AssertionError("phi-cached logits disagree with the uncached ones")
    return model, cached


def time_dx(args, kw, dx, name, card, total):
    """K2's dx kernel alone at one layer (N=32, bf16): its device time
    (`torch.profiler`), its bound (operations: the contraction's 8N per
    (k, s, f) at the bf16 peak; bytes: esb, the output and the units' tap
    records, each once), its plain twin (`_dx_spectra_plain` on phase
    factors built beforehand) and one bf16 `torch.bmm` of (B, 2N, 2F) .
    (B, 2F, S) on prebuilt operands (the contraction alone, V built
    beforehand); adds them into `total` [device, bound, plain, bmm] and
    prints them."""
    xs, es, t1, t2, a1, a2 = args
    esb, wg = dx["esb"], dx["wg"]
    b, n2, f = esb.shape
    s, g = xs.shape[3], a1.shape[1]
    d_dx = _device_ms(lambda: kfb.fused_spectral_grads(*args, **kw, **dx), "spectral_dx_kernel")[0]
    phire, phiim = kfb._phase_factors(t1, t2, a1, a2, kw["p1b"], kw["rbb"], xs.dtype)
    wgf = wg.float()
    t_p = _cuda_ms(lambda: kfb._dx_spectra_plain(esb, phire, phiim, wgf, kw["n_img"]), iters=3)
    del phire, phiim
    lhs = torch.randn((b, n2, 2 * f), device=esb.device).to(torch.bfloat16)
    rhs = torch.randn((b, 2 * f, s), device=esb.device).to(torch.bfloat16)
    t_l = _cuda_ms(lambda: torch.bmm(lhs, rhs))
    del lhs, rhs
    ops = 4 * n2 * b * s * f
    nbytes = _nbytes(esb) + b * n2 * s * 4 + 3 * 4 * g * s * f
    bd, by = _bound(ops, nbytes)
    print(f"layer {name} dx kernel N={n2 // 2} B={b} bf16: device time {d_dx:.4f} ms, bound "
          f"{bd:.4f} ms ({by}), plain twin {t_p:.3f} ms, one bf16 bmm of the contraction alone "
          f"(V built beforehand) {t_l:.4f} ms [{card}]")
    for i, v in enumerate((d_dx, bd, t_p, t_l)):
        total[i] += v
    return total


def time_spectral(gen, dev, card, worst):
    """Per-layer times (N=32, bf16) of K1 and K2 against their twin and the
    unfused torch path, after checking both against the twin at N=32
    (bounds as in `compare_spectral`; `worst` takes the errors); returns
    the sums over conv3-conv5 (where the op runs the kernel) with their
    bounds."""
    out = {k: 0.0 for k in ("k1", "k1_plain", "k2", "k2_plain", "k1_kernel", "k1_device")}
    out["dx"] = [0.0] * 4  # the dx kernel over conv3-conv5: device, bound, plain, bmm
    b1, b2 = Bounds(), Bounds()
    for name, s, f, hw in LAYERS:
        args, kw, dx, (xb, err, mu1, mu2) = _spectral_inputs(
            gen, BATCH, s, f, hw, torch.bfloat16, dev)
        tag = f"{name} bfloat16 N={BATCH}"
        worst["k1"] = max(worst["k1"], _check_err(
            f"K1 {tag}", kfb.fused_spectral_grads(*args, **kw),
            kfb.fused_spectral_grads_plain(*args, **kw), 1e-2))
        got = kfb.fused_spectral_grads(*args, **kw, **dx)
        want = kfb.fused_spectral_grads_plain(*args, **kw, **dx)
        worst["k2"] = max(worst["k2"], _check_err(f"K2 grads {tag}", got[0], want[0], 1e-2),
                          _check_err(f"K2 dx spectra {tag}", got[1], want[1], 1e-2))
        del got, want
        t_k1 = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw))
        d_k1, d_all = _device_ms(lambda: kfb.fused_spectral_grads(*args, **kw), "PhiGather")
        t_p1 = _cuda_ms(lambda: kfb.fused_spectral_grads_plain(*args, **kw), iters=3)
        t_k2 = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw, **dx))
        t_p2 = _cuda_ms(lambda: kfb.fused_spectral_grads_plain(*args, **kw, **dx), iters=3)
        t_unf = _cuda_ms(lambda: fe.fourier_unit_grads(xb, err, mu1, mu2, 9), iters=3)
        t_f2 = _cuda_ms(lambda: fe.fourier_unit_grads_fused2(xb, err, mu1, mu2, 9))
        main = name != "conv2"
        bd1 = (b1 if main else Bounds()).add(*_spectral_work(args, kw))
        bd2 = (b2 if main else Bounds()).add(*_spectral_work(args, kw, dx))
        ops1 = _spectral_work(args, kw)[0]
        print(f"layer {name} K1 N={BATCH} B={kw['p1b'] * kw['rbb']} bf16: kernel {t_k1:.3f} ms "
              f"({ops1 / t_k1 / 1e9:.1f} TFLOP/s, bound {bd1:.4f}; device time: the kernel "
              f"{d_k1:.4f} ms, with the wrapper's torch ops {d_all:.4f} ms), twin {t_p1:.3f} ms; K2 "
              f"kernel {t_k2:.3f} ms (bound {bd2:.4f}), twin {t_p2:.3f} ms; from the blurred "
              f"planes: unfused torch path {t_unf:.3f} ms, DFTs + K1 {t_f2:.3f} ms"
              f"{'' if main else ' (the op takes the unfused path here)'} [{card}]")
        if main:
            for k, v in zip(out, (t_k1, t_p1, t_k2, t_p2, d_k1, d_all)):
                out[k] += v
        time_dx(args, kw, dx, name, card, out["dx"] if main else [0.0] * 4)
    print(f"K1 over conv3-conv5 N={BATCH} bf16: {_k1_line(out, b1)} [{card}]")
    print(f"dx kernel over conv3-conv5 (K2's 3 launches) N={BATCH} bf16: {_dx_line(out['dx'])} "
          f"[{card}]")
    return out, b1, b2


def _dx_line(t):
    return (f"device time {t[0]:.4f} ms, bound {t[1]:.4f} ms, plain twin {t[2]:.3f} ms, one bf16 "
            f"bmm of the contraction alone (V built beforehand) {t[3]:.4f} ms")


def _k1_line(out, bound):
    return (f"kernel with its wrapper {out['k1']:.3f} ms (device time: the kernel "
            f"{out['k1_kernel']:.4f} ms, with the wrapper's torch ops {out['k1_device']:.4f} ms), "
            f"bound {bound.ms:.4f} ms ({bound.bound_by}), twin {out['k1_plain']:.3f} ms")


def _instance(entry):
    """A kernel instance's template arguments read from its mangled name:
    dtype, M and G, and the spectral kernel's gather policy."""
    if "probe_gemm_kernel" in entry:  # its one int argument: A's major
        return "A M-major" if "probe_gemm_kernelILi1E" in entry else "A K-major"
    kind = "bf16" if "bfloat16" in entry else "f32" if re.search(r"If[LE]", entry) else ""
    mg = re.search(r"Li(\d+)ELi(\d+)E", entry)
    # the dx kernel's one int argument, G; K3's G and whether it is chunked
    g = re.search(r"Li(\d+)E(Lb([01])E)?EEv", entry)
    gather = next((g for g in ("PhiGather", "FactoredGather") if g in entry), "")
    chunked = g and g.group(3) == "1" and "chunked"
    # K6's one int argument: the stages per wgmma chain (f32 input 4, bf16 32)
    fold = re.search(r"grad_tables_kernelILi(\d+)E", entry)
    fold = fold and f"folds every {fold.group(1)} stages"
    return " ".join(p for p in (kind, mg and f"M={mg.group(1)} G={mg.group(2)}",
                                not (mg or fold) and g and f"G={g.group(1)}", chunked, gather,
                                fold)
                    if p)


def _ptxas(lib, markers):
    """Print the compiler's registers/spills lines for the entries whose
    mangled name holds every marker; returns {entry: those lines}."""
    lines = build_log(lib).splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "Compiling entry" in line and all(mk in line for mk in markers):
            entry = line.split("'")[1] if "'" in line else line
            found[entry] = " | ".join(l.split("info    : ")[-1].strip() for l in lines[i + 2:i + 4])
            print(f"  {lib} {markers[0]} {_instance(entry)}: {found[entry]}")
    return found


def _instances(lib, markers, kernel, count, spill_free):
    """Print registers and spills of every instance of a kernel (the
    library's entries whose mangled name holds every marker); raise if
    there are not `count` of them or one whose mangled name holds a marker
    of `spill_free` spills."""
    found = _ptxas(lib, markers)
    if len(found) != count:
        raise AssertionError(f"{lib}: {len(found)} {kernel} instances in the build log, "
                             f"expected {count}")
    for entry, info in found.items():
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        if any(mk in entry for mk in spill_free) and (
                spill is None or spill.groups() != ("0", "0")):
            raise AssertionError(f"{kernel} instance {entry} spills: {info}")


def _hgmma_per_instance(lib, marker, kernel, instances=16, tma=False):
    """Print the HGMMA and UTMALDG count of each function of the library's
    SASS whose name holds `marker`; raise if one has no HGMMA (or, with
    `tma`, no UTMALDG), or if there are not `instances` of them."""
    counts, name = {}, None
    for line in disassemble(lib).splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if marker in found.group(1) else None
            if name:
                counts[name] = [0, 0]
        elif name:
            counts[name][0] += len(re.findall(r"\bHGMMA\.", line))
            counts[name][1] += line.count("UTMALDG")
    for name, (hgmma, loads) in sorted(counts.items()):
        print(f"  {lib} {kernel} {_instance(name)}: {hgmma} HGMMA, {loads} UTMALDG")
        if not hgmma or (tma and not loads):
            raise AssertionError(f"{kernel} instance {name}: {hgmma} HGMMA, {loads} UTMALDG")
    if len(counts) != instances:
        raise AssertionError(f"{lib}: {len(counts)} {kernel} functions in the SASS, expected "
                             f"{instances}")


def _tensor_core_count(lib):
    """Print the tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and
    the TMA loads (UTMALDG) in the library's SASS; raise if it has no
    tensor-core instruction or no TMA load."""
    sass = disassemble(lib)
    counts = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
    tma = sass.count("UTMALDG")
    print(f"  {lib} SASS: {counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA, "
          f"{tma} UTMALDG (TMA loads)")
    if not any(counts.values()):
        raise AssertionError(f"{lib}: no tensor-core instruction in the SASS")
    if not tma:
        raise AssertionError(f"{lib}: no TMA load in the SASS")


def _dense_work(n, s, f, hw, x_bytes, kb: int = 0, g: int = G):
    """(operations, bytes) of K5 (blur filter kb x kb) or K4 (kb=0) at a
    layer shape: the 4*G bilinear taps per (s, f, pixel), plus the kb x kb
    blur per (s, pixel) for K5; x, the three (S, G, F) parameter tensors and
    the output in bf16."""
    ops = 2 * 4 * g * s * f * hw * hw * n + 2 * kb * kb * s * hw * hw * n
    return ops, x_bytes + 3 * s * g * f * 2 + n * f * hw * hw * 2


def time_k5(x, w, mu1, mu2, filt, ks, bound):
    """K5 at one shape (bf16): (wrapper ms, its operand building ms, twin
    ms, two-call library chain ms, bound ms added to `bound`, dense
    ks^2-tap GEMM at the bf16 peak ms). The chain is a bf16 depthwise
    `conv2d` blur (groups=S) and a bf16 `conv2d` with the synthesized K,
    synthesized beforehand."""
    n, s, hw, _ = x.shape
    f, kb = w.shape[-1], filt.shape[-1]
    t_k = _cuda_ms(lambda: kfwd.dau_forward_fused(x, w, mu1, mu2, filt, ks))
    t_o = _cuda_ms(lambda: kfwd.fused_forward_operands(x, w, mu1, mu2, filt, ks))
    t_p = _cuda_ms(lambda: kfwd.dau_forward_fused_plain(x, w, mu1, mu2, filt, ks))
    blur = filt.to(x.dtype).expand(s, 1, kb, kb).contiguous()
    kern = xla_engine.synthesize_kernel(w, mu1, mu2, ks).transpose(0, 1).contiguous()
    conv = torch.nn.functional.conv2d
    t_l = _cuda_ms(lambda: conv(conv(x, blur, padding=kb // 2, groups=s), kern, padding=ks // 2))
    bd = bound.add(*_dense_work(n, s, f, hw, _nbytes(x), kb, w.shape[-2]))
    peak = 2 * ks * ks * s * f * hw * hw * n / PEAK_BF16 * 1e3
    return t_k, t_o, t_p, t_l, bd, peak


def _k5_line(t):
    t_k, t_o, t_p, t_l, bd, peak = t
    return (f"kernel {t_k:.3f} ms (operand building {t_o:.3f} ms), plain {t_p:.3f} ms, "
            f"library chain {t_l:.3f} ms, bound {bd:.4f} ms (4*G taps), dense GEMM at peak "
            f"{peak:.4f} ms")


# kernel-name fragments -> the breakdown's categories, first match wins
CATEGORIES = (("K5 fused_forward_kernel", ("fused_forward_kernel",)),
              ("K4 aggregate_kernel", ("aggregate_kernel",)),
              ("K6 grad_tables_kernel", ("grad_tables_kernel",)),
              ("K8 spectral_grads_kernel<FactoredGather>", ("FactoredGather",)),
              ("K1/K2 spectral_grads_kernel<PhiGather>", ("spectral_grads_kernel",)),
              ("K2/K8 spectral_dx_kernel", ("spectral_dx_kernel",)),
              ("GEMM (cuBLAS)", ("gemm", "Gemm", "cutlass", "xmma", "sm90_", "sm80_")),
              ("convolution (cuDNN)", ("conv", "cudnn", "Conv")),
              ("elementwise / reduce / copy", ("elementwise", "Elementwise", "reduce", "Reduce",
                                               "copy", "Copy", "cat", "index", "fill")))


def profile_step(name, step, x, labels, step_ms, card, steps: int = 3):
    """Device time by kernel over `steps` profiled steps (torch.profiler,
    after one warm-up): per-category and top-kernel ms per step, and the
    device's busy share of `step_ms`, the step's CUDA-event time measured
    without the profiler (the profiler slows the host)."""
    step(x, labels)
    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, labels)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy = device_busy_ms(prof)
    if busy is None:
        print(f"profile: torch.profiler recorded no device time [{card}]")
        return
    device_ms = busy / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    cats = {}
    for key, ms, _ in rows:
        cat = next((c for c, frags in CATEGORIES if any(fr in key for fr in frags)), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    host = [(e.key, e.self_cpu_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
    print(f"profile {name} step (bf16, {steps} steps): device busy {device_ms:.3f} ms per "
          f"step, {100 * device_ms / step_ms:.1f}% of the {step_ms:.3f} ms step (host clock "
          f"under the profiler {host_ms:.3f} ms); {sum(c for _, _, c in rows)} kernel "
          f"launches and {sum(c for _, _, c in host)} aten ops per step [{card}]")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  top: {ms:.3f} ms x{count} {key[:110]}")
    for key, ms, count in sorted(host, key=lambda r: -r[1])[:8]:
        print(f"  host: {ms:.3f} ms self CPU (under the profiler) x{count} {key}")


def compare_gathers(grads, phi_grads, what):
    """Every gradient of one f32 step against another's, within
    1e-3*max|grad|: the two gathers compute the same function."""
    worst = 0.0
    for name, want in phi_grads.items():
        err = float((grads[name] - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{what}: {name} max|dg|={err:.3e} max|g|={scale:.3e}")
    print(f"{what}: {len(phi_grads)} gradients, worst max|dg|/max|g| = {worst:.3e} "
          f"(bound 1e-3)")


def _idft_inputs(gen, n, s, f, hw, dtype, dev):
    """`fourier_grad_tables`' K7 operands at a layer shape: the (B, 81) iDFT
    matrices and the (B, M*S*F) cross-spectra of random blurred planes (M=3)
    and error, in `dtype`; and the planes, error and random offsets."""
    xb = torch.randn((M, n, s, hw, hw), generator=gen).to(dev, dtype)
    err = torch.randn((n, f, hw, hw), generator=gen).to(dev, dtype)
    mu1, mu2 = (torch.rand((2, s, G, f), generator=gen) * 7.98 - 3.99).to(dev, dtype)
    tre, tim, (p1, p2, rb) = fe.fourier_cross_spectra(xb, err, 9)
    pos = range(-4, 5)
    cmat, smat = fe._idft_mats(p1, p2, rb, pos, pos, tre.dtype, dev)
    return (cmat, smat, tre.reshape(p1 * rb, -1), tim.reshape(p1 * rb, -1)), (xb, err, mu1, mu2)


def _idft_work(ops, out_dtype):
    """(operations, bytes) of one K7 call: 4 per (bin, position, column);
    each operand read once, the table written once."""
    cmat, _, tre, _ = ops
    (b, p), c = cmat.shape, tre.shape[1]
    return 4 * b * p * c, _nbytes(*ops) + p * c * torch.empty((), dtype=out_dtype).element_size()


def compare_idft(gen, dev):
    """Phase 16: K7 vs its twin at each layer's cross-spectra (N=4, M=3), f32
    (bound 1e-4*max|ref|) and bf16 (the table rounded to bf16: 1e-2), and at
    K3's closing operands (f32 spectra, 1e-4); and the 'pmsf' gather of
    `fourier_grad_tables` against `fourier_unit_grads` (f32 1e-4, bf16 2e-2:
    the gathers round at different places). Returns the largest |error| of
    K7."""
    worst = 0.0
    for name, s, f, hw in LAYERS:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            tag = f"{name} {str(dtype)[6:]}"
            ops, (xb, err, mu1, mu2) = _idft_inputs(gen, 4, s, f, hw, dtype, dev)
            got = ksp.partial_idft(*ops, out_dtype=dtype)
            if got.dtype != dtype:
                raise AssertionError(f"K7 {tag}: table is {got.dtype}")
            worst = max(worst, _check_err(f"K7 {tag} B={ops[0].shape[0]} C={ops[2].shape[1]}",
                                          got, ksp.partial_idft_plain(*ops), bound))
            table = fe.fourier_grad_tables(xb, err, 9)
            _check_err(f"tap_gather(fourier_grad_tables, 'pmsf') vs fourier_unit_grads {tag}",
                       xla_engine.tap_gather(table, mu1, mu2, 9, table_layout="pmsf"),
                       fe.fourier_unit_grads(xb, err, mu1, mu2, 9), 2 * bound if
                       dtype == torch.bfloat16 else bound)
    # K3's closing launch: the fused apply-phi's (HWp, B) iDFT matrices (P =
    # 169 or 729 rows, padded to 8) against the f32 spectra of N=4 images
    for name, s, f, hw in LAYERS[:2]:
        p1, p2, rb = fe.plan_bins(hw, hw, 9)
        dct, dst, _ = fe._fused_idft_mats(p1, p2, rb, hw, hw, dev)
        yre, yim = torch.randn((2, p1 * rb, 4 * f), generator=gen).to(dev)
        worst = max(worst, _check_err(
            f"K7 {name} K3 closing P={dct.shape[0]} B={p1 * rb} C={4 * f} f32",
            ksp.partial_idft(dct.t(), dst.t(), yre, yim),
            ksp.partial_idft_plain(dct.t(), dst.t(), yre, yim), 1e-4))
    return worst


def _apply_phi_inputs(gen, n, s, f, hw, contract_f, dtype, dev, ks=9):
    """K3's operands at a layer shape as `fourier_apply_phi_fused` makes
    them (forward: CI=S, CO=F; contract_f: CI=F, CO=S) at kernel size ks
    (nj = 2*(ks//2 + 1) + 2 exponents); and the image, w, mu1, mu2 behind
    them (|mu| up to ks//2 - 0.01)."""
    p1, p2, rb = fe.plan_bins(hw, hw, ks)
    span = ks // 2 + 1
    lim = ks // 2 - 0.01
    x = torch.rand((n, f if contract_f else s, hw, hw), generator=gen).to(dev, dtype)
    w = (torch.randn((s, G, f), generator=gen) * 0.1).to(dev, dtype)
    mu1, mu2 = ((torch.rand((2, s, G, f), generator=gen) * 2 - 1) * lim).to(dev, dtype)
    xre, xim = fe._rdft2(x, p1, p2, rb)
    order = (0, 2, 3, 1) if contract_f else (0, 2, 1, 3)
    aw = fe._phase_onehot(mu2, span, True) * w.float()[None]
    dct, dst, _ = fe._fused_idft_mats(p1, p2, rb, hw, hw, dev)
    ops = dict(xs=torch.cat([xre, xim], dim=0).permute(2, 0, 1).contiguous(),
               t1=fe._phase_table(p1, p1, span, torch.float32, dev, conj=contract_f),
               t2=fe._phase_table(p2, rb, span, torch.float32, dev, conj=contract_f),
               aw=aw.permute(order).to(dtype),
               a=fe._phase_onehot(mu1, span, True).permute(order).to(dtype), dct=dct, dst=dst)
    return ops, dict(n_img=n, p1b=p1, rbb=rb), (x, w, mu1, mu2)


def _apply_phi_work(ops, kw):
    """(operations, bytes) of one K3 call: the per-bin complex products (8
    per (bin, n, ci, co)), Phi's build (14 per (bin, ci, co, unit)) and the
    partial iDFT (4 per (position, bin, n, co)); each operand read once, the
    f32 output written once."""
    b, n2, ci = ops["xs"].shape
    nj, g, _, co = ops["aw"].shape
    hwp = ops["dct"].shape[0]
    ops_count = 4 * b * n2 * ci * co + 14 * g * b * ci * co + 2 * hwp * b * n2 * co
    return ops_count, _nbytes(*ops.values()) + hwp * (n2 // 2) * co * 4


def _unfused_apply(x, w, mu1, mu2, contract_f):
    """The unfused chain K3 replaces: `fourier_forward`, or
    `fourier_input_grad` on a Phi built beforehand."""
    if not contract_f:
        return fe.fourier_forward(x, w, mu1, mu2, 9)
    p1, p2, rb = fe.plan_bins(*x.shape[-2:], 9)
    return fe.fourier_input_grad(x, fe.build_phi(w, mu1, mu2, p1, p2, rb, True, 5), 9)


def compare_apply_phi(gen, dev):
    """Phase 17: K3 vs its twin, forward and contract_f, at each layer
    shape (N=4), f32 (bound 1e-4*max|ref|) and bf16 (Phi rounded to bf16 in
    both: 1e-2); and `fourier_apply_phi_fused` against the unfused chain
    within 1e-4 (f32) / 1e-2 (bf16) * max|y|; then K3 at ks 33 and 65 (nj
    36 and 68) on a small plane (N=4, S=16, F=24, 7x7) against its twin,
    bounds as above. Returns the largest |error| of K3."""
    worst = 0.0
    for ks in (33, 65):
        for contract_f in (False, True):
            for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
                tag = f"ks{ks} {'contract_f' if contract_f else 'forward'} {str(dtype)[6:]}"
                ops, kw, _ = _apply_phi_inputs(gen, 4, 16, 24, 7, contract_f, dtype, dev, ks)
                worst = max(worst, _check_err(
                    f"K3 {tag} nj={ops['aw'].shape[0]} B={ops['xs'].shape[0]}",
                    kff.fused_apply_phi(**ops, **kw), kff.fused_apply_phi_plain(**ops, **kw),
                    bound))
    for name, s, f, hw in LAYERS:
        for contract_f in (False, True):
            for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
                tag = f"{name} {'contract_f' if contract_f else 'forward'} {str(dtype)[6:]}"
                ops, kw, (x, w, mu1, mu2) = _apply_phi_inputs(gen, 4, s, f, hw, contract_f,
                                                              dtype, dev)
                worst = max(worst, _check_err(f"K3 {tag}", kff.fused_apply_phi(**ops, **kw),
                                              kff.fused_apply_phi_plain(**ops, **kw), bound))
                got = fe.fourier_apply_phi_fused(x, w, mu1, mu2, 9, contract_f=contract_f)
                if got.dtype != dtype:
                    raise AssertionError(f"fourier_apply_phi_fused {tag}: {got.dtype}")
                _check_err(f"fourier_apply_phi_fused vs unfused {tag}", got,
                           _unfused_apply(x, w, mu1, mu2, contract_f), bound)
    return worst


def path_counts(what, fn, want):
    """Drive `fn` with every launch counter at 0 and check the counts it
    leaves against `want` (COUNTS' order); returns them."""
    _zero_counts()
    fn()
    torch.cuda.synchronize()
    got = _counts()
    print(f"{what}: launches {COUNTS} {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def time_new_kernels(gen, dev, card, worst):
    """Phase 18: per-layer times (N=32, bf16) of K8 (and with dx) against its
    twin, K1 and the unfused torch path; K7 against its twin and one matmul;
    K3 (both directions) against its twin and the unfused chain; each
    checked against its twin at N=32 first (`worst` takes the errors).
    Returns {kernel: (ms, plain_ms, library_ms or None, Bounds)} summed over
    the layers."""
    out = {k: [0.0, 0.0, None, Bounds()] for k in ("k8", "k8dx", "k7", "k3")}
    out["k7"][2] = out["k3"][2] = 0.0
    # K3's device time over the layers and directions: the products kernel,
    # the operand building, the closing launch, the whole call
    out["k3dev"] = [0.0] * 4
    # K8's device time summed over the layers: the kernel alone, with its
    # operand kernel and the wrapper's sum, and the dx kernel of K8 dx
    out["k8dev"] = [0.0, 0.0, 0.0]
    out["dx"] = [0.0] * 4  # the dx kernel over the four layers: device, bound, plain, bmm
    for name, s, f, hw in LAYERS:
        tag = f"{name} bfloat16 N={BATCH}"
        args, kw, dx, (xb, err, mu1, mu2) = _spectral_inputs(
            gen, BATCH, s, f, hw, torch.bfloat16, dev)
        worst["k8"] = max(worst["k8"], _check_err(
            f"K8 {tag}", kfb.fused_spectral_grads(*args, **kw, gather="factored"),
            kfb.fused_factored_grads_plain(*args, **kw), 1e-2))
        t_k = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw, gather="factored"))
        d_k, d_all = _device_ms(lambda: kfb.fused_spectral_grads(*args, **kw, gather="factored"),
                                "FactoredGather")
        d_dx = _device_ms(lambda: kfb.fused_spectral_grads(*args, **kw, **dx, gather="factored"),
                          "spectral_dx_kernel")[0]
        t_p = _cuda_ms(lambda: kfb.fused_factored_grads_plain(*args, **kw), iters=3)
        t_kd = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw, **dx, gather="factored"))
        t_pd = _cuda_ms(lambda: kfb.fused_factored_grads_plain(*args, **kw, **dx), iters=3)
        t_k1 = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw))
        t_unf = _cuda_ms(lambda: fe.fourier_unit_grads(xb, err, mu1, mu2, 9), iters=3)
        t_f2 = _cuda_ms(lambda: fe.fourier_unit_grads_fused2(xb, err, mu1, mu2, 9,
                                                             gather="factored"))
        bd = out["k8"][3].add(*_spectral_work(args, kw))
        bdd = out["k8dx"][3].add(*_spectral_work(args, kw, dx))
        print(f"layer {name} K8 N={BATCH} B={kw['p1b'] * kw['rbb']} bf16: kernel {t_k:.3f} ms "
              f"(bound {bd:.4f}; device time: the kernel {d_k:.4f} ms, with its operand "
              f"kernel and sum {d_all:.4f} ms), twin {t_p:.3f} ms; K8 dx kernel {t_kd:.3f} ms "
              f"(bound {bdd:.4f}; its dx kernel {d_dx:.4f} ms device time), twin {t_pd:.3f} "
              f"ms; K1 kernel {t_k1:.3f} ms; from the blurred planes: unfused torch path "
              f"{t_unf:.3f} ms, DFTs + K8 {t_f2:.3f} ms [{card}]")
        for k, (a, b) in (("k8", (t_k, t_p)), ("k8dx", (t_kd, t_pd))):
            out[k][0] += a
            out[k][1] += b
        out["k8dev"] = [a + b for a, b in zip(out["k8dev"], (d_k, d_all, d_dx))]
        time_dx(args, kw, dx, name, card, out["dx"])
        del args, dx, xb

        ops, _ = _idft_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        worst["k7"] = max(worst["k7"], _check_err(
            f"K7 {tag}", ksp.partial_idft(*ops, out_dtype=torch.bfloat16),
            ksp.partial_idft_plain(*ops), 1e-2))
        t_k = _cuda_ms(lambda: ksp.partial_idft(*ops, out_dtype=torch.bfloat16))
        t_p = _cuda_ms(lambda: ksp.partial_idft_plain(*ops, out_dtype=torch.bfloat16))
        # one library call of the same function: [C; -S]^T @ [tre; tim] in
        # bf16 (cuBLAS), its operands stacked beforehand
        lhs = torch.cat([ops[0], -ops[1]]).t().contiguous()
        rhs = torch.cat([ops[2], ops[3]])
        t_l = _cuda_ms(lambda: torch.matmul(lhs, rhs))
        bd = out["k7"][3].add(*_idft_work(ops, torch.bfloat16))
        print(f"layer {name} K7 N={BATCH} B={ops[0].shape[0]} C={ops[2].shape[1]} bf16: kernel "
              f"{t_k:.3f} ms (bound {bd:.4f}), twin {t_p:.3f} ms, one matmul {t_l:.3f} ms "
              f"[{card}]")
        out["k7"][0] += t_k
        out["k7"][1] += t_p
        out["k7"][2] += t_l
        del ops, lhs, rhs

        for contract_f in (False, True):
            ops, kw, (x, w, mu1, mu2) = _apply_phi_inputs(gen, BATCH, s, f, hw, contract_f,
                                                          torch.bfloat16, dev)
            way = "contract_f" if contract_f else "forward"
            worst["k3"] = max(worst["k3"], _check_err(
                f"K3 {tag} {way}", kff.fused_apply_phi(**ops, **kw),
                kff.fused_apply_phi_plain(**ops, **kw), 1e-2))
            t_k = _cuda_ms(lambda: kff.fused_apply_phi(**ops, **kw))
            t_p = _cuda_ms(lambda: kff.fused_apply_phi_plain(**ops, **kw), iters=3)
            t_f = _cuda_ms(lambda: fe.fourier_apply_phi_fused(x, w, mu1, mu2, 9,
                                                              contract_f=contract_f))
            t_u = _cuda_ms(lambda: _unfused_apply(x, w, mu1, mu2, contract_f))
            # its closing launch alone: the split of f32 Y of this shape into
            # bf16 hi/lo parts, and K7's kernel on them
            dct, dst = ops["dct"], ops["dst"]
            co = ops["aw"].shape[-1]
            y = torch.randn((dct.shape[1], 2 * BATCH, co), generator=gen).to(dev)

            def close():
                parts = kff._split_cuda(kff._library(), y, BATCH)
                return ksp.idft_launch_split(dct.t(), dst.t(), parts, BATCH * co, torch.float32,
                                             mat_dtype=torch.bfloat16)

            t_c = _cuda_ms(close)
            # device time: the products kernel alone, the whole call, the
            # closing launch alone; the operand building is the rest
            d_k, d_all = _device_ms(lambda: kff.fused_apply_phi(**ops, **kw), K3_PRODUCTS)
            d_op = _device_ms(lambda: kff.fused_apply_phi(**ops, **kw),
                              "apply_phi_operands_kernel")[0]
            d_c = _device_ms(close, "")[1]
            d_o = d_all - d_k - d_c
            del y
            # the yardstick: one bf16 bmm of the per-bin products alone, Phi
            # built beforehand: [Xre | Xim] (B, N, 2CI) . [[Phre, Phim];
            # [-Phim, Phre]] (B, 2CI, 2CO)
            b, n2, ci = ops["xs"].shape
            lhs = torch.randn((b, n2 // 2, 2 * ci), device=dev).to(torch.bfloat16)
            rhs = torch.randn((b, 2 * ci, 2 * co), device=dev).to(torch.bfloat16)
            t_l = _cuda_ms(lambda: torch.bmm(lhs, rhs))
            del lhs, rhs
            bd = out["k3"][3].add(*_apply_phi_work(ops, kw))
            print(f"layer {name} K3 {way} N={BATCH} bf16: kernel {t_k:.3f} ms (bound "
                  f"{bd:.4f}; its closing launch alone {t_c:.3f} ms; device time: the products "
                  f"kernel {d_k:.4f} ms, the operand building {d_o:.4f} ms (its operand kernel "
                  f"{d_op:.4f} ms), the closing launch "
                  f"{d_c:.4f} ms, the whole call {d_all:.4f} ms), twin {t_p:.3f} ms, one bf16 "
                  f"bmm of the products alone (Phi built beforehand) {t_l:.4f} ms; from the "
                  f"image: fourier_apply_phi_fused {t_f:.3f} ms, unfused chain {t_u:.3f} ms "
                  f"[{card}]")
            out["k3"][0] += t_k
            out["k3"][1] += t_p
            out["k3"][2] += t_l
            out["k3dev"] = [a + b for a, b in zip(out["k3dev"], (d_k, d_o, d_c, d_all))]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 2
    if Path(dau_convnet_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    # TF32 off for the plain twins' f32 cuDNN/cuBLAS calls made here
    # directly; the op no longer depends on it: at precision='highest' its
    # own convolutions turn cuDNN's TF32 off (ops/_precision.py)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_run = time.perf_counter()
    card = _card()
    print(f"card: {card}")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    build(LIBRARIES)
    print(f"build: {', '.join(LIBRARIES)} (.cu) for sm_90a, one nvcc each, "
          f"{time.perf_counter() - t0:.1f} s; ptxas:")
    _ptxas("dau_forward_fused", ["fused_forward_kernel"])
    _ptxas("dau_aggregate", ["aggregate_kernel"])
    # K6: the f32 and the bf16 instance (folding their wgmma chains every 4
    # and 32 stages) spill-free
    _instances("dau_grad_tables", ["grad_tables_kernel"], "K6", 2, ("grad_tables_kernel",))
    # K1 and K8: f32/bf16 x M 3, 4 x G 1-4; K1 spill-free at M=3, G=2, K8
    # everywhere
    _instances("dau_spectral_grads", ["spectral_grads_kernel", "PhiGather"], "K1", 16,
               ("Li3ELi2E",))
    _instances("dau_spectral_grads", ["spectral_grads_kernel", "FactoredGather"], "K8", 16,
               ("FactoredGather",))
    # K2's dx kernel: f32/bf16 x G 1-4, spill-free at bf16, G = 2
    _instances("dau_spectral_grads", ["spectral_dx_kernel"], "dx kernel", 8,
               ("I13__nv_bfloat16Li2EEEv",))
    _ptxas("dau_partial_idft", ["partial_idft_kernel"])
    # K3's products kernel: f32/bf16 x G 1-4, and the chunked G = 4;
    # spill-free at bf16, G = 2 (the AlexNet-DAU path's)
    _instances("dau_apply_phi", [K3_PRODUCTS], "K3 products kernel", 10,
               ("I13__nv_bfloat16Li2ELb0E",))
    _ptxas("dau_apply_phi", ["apply_phi_operands_kernel"])
    for lib in ("dau_forward_fused", "dau_aggregate", "dau_grad_tables", "dau_partial_idft",
                "dau_spectral_grads", "dau_apply_phi"):
        _tensor_core_count(lib)
    _hgmma_per_instance("dau_spectral_grads", "FactoredGather", "K8")
    # K2's dx kernel: f32/bf16 x G 1-4, its B operand by TMA
    _hgmma_per_instance("dau_spectral_grads", "spectral_dx_kernel", "dx kernel", 8, tma=True)
    # K3's products kernel: f32/bf16 x (G 1-4, and chunked G 4), B by TMA
    _hgmma_per_instance("dau_apply_phi", K3_PRODUCTS, "K3 products kernel", 10, tma=True)
    # the probes' kernels: the GEMM's two instances (A K-major, M-major) on
    # TMA and wgmma; the gather and the stream kernels plain CUDA
    _instances("dau_probe_gemm", ["probe_gemm_kernel"], "probe GEMM", 2, ("probe_gemm_kernel",))
    _hgmma_per_instance("dau_probe_gemm", "probe_gemm_kernel", "probe GEMM", 2, tma=True)
    _ptxas("dau_probe_gather", ["probe_gather_kernel"])
    for kernel in ("scale_kernel", "colsum_partial_kernel", "colsum_final_kernel",
                   "add_one_kernel", "copy_tiles_kernel"):
        _ptxas("dau_probe_stream", [kernel])

    # 2. kernel vs twin
    gen = torch.Generator().manual_seed(args.seed)
    ks = DAUConvSettings().synth_kernel_size
    filt = gaussian_filters(0.5, size=9, device=dev)["w"]
    worst = compare(gen, dev, filt, ks)

    # 3. serving in bf16 through the kernel
    model = AlexNetDAU(variant="default", image_size=IMAGE, engine="pallas_fused", dtype=torch.bfloat16,
                       device=dev, generator=torch.Generator().manual_seed(args.seed))
    model.eval()
    requests = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
                for _ in range(REQUESTS)]
    _zero_counts()
    with torch.inference_mode():
        for i, req in enumerate(requests):
            logits = model(req)
            torch.cuda.synchronize()
            if kfwd.dau_forward_fused.launches != 4 * (i + 1):
                raise AssertionError(f"request {i}: {kfwd.dau_forward_fused.launches} "
                                     "kernel launches, expected 4 per request")
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits.float()).all():
                raise AssertionError(f"request {i}: bad logits {tuple(logits.shape)}")
    if any(_counts()[1:]):
        raise AssertionError(f"serving launched kernels other than K5: {_counts()}")
    launches = kfwd.dau_forward_fused.launches
    print(f"serving: {REQUESTS} requests of {BATCH}x3x{IMAGE}x{IMAGE} bf16, "
          f"{launches} kernel launches, logits finite")

    # 4. f32 reference: kernel path vs plain path on the same weights
    ref_model = AlexNetDAU(variant="default", image_size=IMAGE, engine="pallas_fused", dtype=torch.float32,
                           device=dev, generator=torch.Generator().manual_seed(args.seed))
    ref_model.eval()
    with torch.inference_mode():
        y_kernel = ref_model(requests[0])
        with plain_twin():
            y_plain = ref_model(requests[0])
    err = float((y_kernel - y_plain).abs().max())
    scale = float(y_plain.abs().max())
    print(f"reference f32: max|dlogits|={err:.3e} max|logits|={scale:.3e} "
          f"bound={1e-3 * scale:.3e}")
    if not err <= 1e-3 * scale:
        raise AssertionError("f32 kernel path disagrees with the plain path")

    # 5. timing
    k5 = [0.0] * 6  # bf16 forward sums: wrapper, operands, twin, chain, bound, dense peak
    k5_bound = Bounds()
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for name, s, f, hw in LAYERS:
                x, w, mu1, mu2 = _layer_inputs(gen, BATCH, s, f, hw, dtype, dev)
                gflops = 2 * ks * ks * s * f * hw * hw * BATCH / 1e9
                if dtype == torch.bfloat16:
                    t = time_k5(x, w, mu1, mu2, filt, ks, k5_bound)
                    k5 = [a + b for a, b in zip(k5, t)]
                    print(f"layer {name} K5 {s}->{f} N={BATCH} bf16: {_k5_line(t)}, "
                          f"{gflops / t[0]:.1f} TFLOP/s dense [{card}]")
                    continue
                t_k = _cuda_ms(lambda: kfwd.dau_forward_fused(x, w, mu1, mu2, filt, ks))
                t_p = _cuda_ms(lambda: kfwd.dau_forward_fused_plain(x, w, mu1, mu2, filt, ks))
                print(f"layer {name} K5 {s}->{f} N={BATCH} f32: kernel {t_k:.3f} ms "
                      f"({gflops / t_k:.1f} TFLOP/s dense), plain {t_p:.3f} ms [{card}]")
        print(f"K5 over the 4 launches of a pallas_fused request N={BATCH} bf16: "
              f"{_k5_line(k5)} [{card}]")
        for m, tag in ((model, "bf16"), (ref_model, "f32")):
            t_k = _cuda_ms(lambda: m(requests[0]), iters=5)
            with plain_twin():
                t_p = _cuda_ms(lambda: m(requests[0]), iters=5)
            print(f"request {BATCH}x3x{IMAGE}x{IMAGE} {tag}: kernel path {t_k:.3f} ms, "
                  f"plain path {t_p:.3f} ms [{card}]")
    del ref_model

    # 6. backward kernels vs twins
    worst_bwd = compare_backward(gen, dev, ks)

    # 7. training in bf16, each engine's path read on its own
    batches = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
               for _ in range(STEPS)]
    labels = torch.randint(0, 1000, (BATCH,), generator=gen).to(dev)
    runs = {}
    for engine in ("pallas_fused", "pallas"):
        runs[engine] = _train_run(engine, dev, args.seed, batches, labels)

    # 8. f32 reference step: kernels vs twins
    for engine in ("pallas_fused", "pallas"):
        reference_step(engine, dev, args.seed, batches[0], labels)

    # 9. timing of the backward kernels and the training step
    k6_ms = k6_ops = k6_plain = k6_lib = k4_ops = k4_plain = k4_lib = k4_peak = 0.0
    k4_ms = {"forward": 0.0, "dx": 0.0}
    k6_bound, k4_bound, k5dx_bound = Bounds(), Bounds(), Bounds()
    k5dx = [0.0] * 6
    error_filt = gaussian_filters(0.5, size=9, device=dev)["error"]
    for name, s, f, hw in LAYERS:
        xb, err = _tables_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        t_k = _cuda_ms(lambda: kbwd.grad_tables(xb, err, ks))
        # the wrapper's share: its operand copies alone
        t_o = _cuda_ms(lambda: kbwd.grad_tables_operands(xb, err))
        t_p = _cuda_ms(lambda: kbwd.grad_tables_plain(xb, err, ks))
        # one library call of the same function: the table as one bf16
        # correlation (cuDNN), its operands laid out beforehand
        lhs = xb.transpose(1, 2).reshape(M * s, BATCH, hw, hw)
        rhs = err.transpose(0, 1).contiguous()
        t_l = _cuda_ms(lambda: torch.nn.functional.conv2d(lhs, rhs, padding=ks // 2))
        gflops = 2 * ks * ks * M * s * f * hw * hw * BATCH / 1e9
        bd = k6_bound.add(gflops * 1e9, _nbytes(xb, err) + M * s * f * ks * ks * 4)
        print(f"layer {name} K6 N={BATCH} M={M} bf16: kernel {t_k:.3f} ms "
              f"({gflops / t_k:.1f} TFLOP/s; its operand copies {t_o:.3f} ms), plain "
              f"{t_p:.3f} ms, conv2d {t_l:.3f} ms, bound {bd:.4f} ms [{card}]")
        k6_ms, k6_ops, k6_plain, k6_lib = k6_ms + t_k, k6_ops + t_o, k6_plain + t_p, k6_lib + t_l
        x, w, mu1, mu2 = _layer_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        e, wt, m1, m2 = _dx_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        # K4 at the step's two calls per layer: the forward (S -> F) and
        # the dx pass (F -> S, on the error, transposed params)
        for way, args4, s_in, f_out in (("forward", (x, w, mu1, mu2), s, f),
                                        ("dx", (e, wt, m1, m2), f, s)):
            t_k = _cuda_ms(lambda: kfwd.aggregate_forward(*args4, ks))
            # the wrapper's share: its operand building (synthesis, layout)
            t_o = _cuda_ms(lambda: kfwd.aggregate_forward_operands(*args4, ks))
            t_p = _cuda_ms(lambda: kfwd.aggregate_forward_plain(*args4, ks))
            # one library call: the aggregation as one bf16 convolution with
            # the synthesized kernel (synthesized beforehand)
            kern = xla_engine.synthesize_kernel(*args4[1:], ks).transpose(0, 1).contiguous()
            t_l = _cuda_ms(lambda: torch.nn.functional.conv2d(args4[0], kern, padding=ks // 2))
            bd = k4_bound.add(*_dense_work(BATCH, s_in, f_out, hw, _nbytes(args4[0])))
            # the dense ks^2-tap GEMM the kernel executes, at the bf16 peak
            dense = 2 * ks * ks * s_in * f_out * hw * hw * BATCH
            peak = dense / PEAK_BF16 * 1e3
            print(f"layer {name} K4 {way} {s_in}->{f_out} N={BATCH} bf16: kernel {t_k:.3f} ms "
                  f"({dense / t_k / 1e9:.1f} TFLOP/s dense; operand building {t_o:.3f} ms), "
                  f"plain {t_p:.3f} ms, conv2d {t_l:.3f} ms, bound {bd:.4f} ms (4*G taps), "
                  f"dense {ks * ks}-tap GEMM at peak {peak:.4f} ms [{card}]")
            k4_ms[way] += t_k
            k4_ops, k4_plain, k4_lib, k4_peak = (k4_ops + t_o, k4_plain + t_p, k4_lib + t_l,
                                                 k4_peak + peak)
        t = time_k5(e, wt, m1, m2, error_filt, ks, k5dx_bound)
        k5dx = [a + b for a, b in zip(k5dx, t)]
        print(f"layer {name} K5 dx {f}->{s} N={BATCH} bf16: {_k5_line(t)} [{card}]")
    del xb, err, lhs, rhs, x, e, kern
    print(f"K6 over the four layers N={BATCH} M={M} bf16: kernel {k6_ms:.3f} ms (its operand "
          f"copies {k6_ops:.3f} ms), bound {k6_bound.ms:.4f} ms ({k6_bound.bound_by}), conv2d "
          f"{k6_lib:.3f} ms, plain {k6_plain:.3f} ms [{card}]")
    k4_sum = k4_ms["forward"] + k4_ms["dx"]
    print(f"K4 over the 8 launches of a pallas step (four forward, four dx shapes) N={BATCH} "
          f"bf16: kernel {k4_sum:.3f} ms (forward {k4_ms['forward']:.3f}, dx "
          f"{k4_ms['dx']:.3f}; operand building {k4_ops:.3f}), conv2d {k4_lib:.3f} ms, plain "
          f"{k4_plain:.3f} ms, bound {k4_bound.ms:.4f} ms ({k4_bound.bound_by}; 4*G taps), "
          f"dense 81-tap GEMM at the bf16 peak {k4_peak:.4f} ms [{card}]")
    print(f"K5 over the 4 dx launches of a pallas_fused step N={BATCH} bf16: "
          f"{_k5_line(k5dx)}; with the forward four, 8 launches: kernel "
          f"{k5[0] + k5dx[0]:.3f} ms, library chain {k5[3] + k5dx[3]:.3f} ms [{card}]")

    # 10. K1/K2 vs twin
    worst_spec = compare_spectral(gen, dev)

    # 11. Fourier serving, uncached and phi-cached
    fmodel, cmodel = serve_fourier(dev, args.seed, requests, card)

    # 12. Fourier training in bf16, then the f32 reference steps
    for engine in ("fourier", "fourier fused_dx"):
        runs[engine] = _train_run(engine, dev, args.seed, batches, labels)
    phi_grads = reference_step("fourier", dev, args.seed, batches[0], labels, fused_bwd="on")[1]
    reference_step("fourier", dev, args.seed, batches[0], labels, fused_bwd="on", fused_dx="on")

    # 13. timing: K1/K2 per layer, requests, steps, peak memory
    spec, k1_bound, k2_bound = time_spectral(gen, dev, card, worst_spec)
    with torch.inference_mode():
        for tag, m in (("fourier", fmodel), ("fourier phi-cached", cmodel),
                       ("pallas_fused", model), ("fourier phi-cached", cmodel),
                       ("fourier", fmodel)):
            t_k = _spread(lambda: m(requests[0]))
            print(f"request {BATCH}x3x{IMAGE}x{IMAGE} bf16 {tag}: {_fmt(t_k)} over 5 runs of "
                  f"5 [{card}]")
    del fmodel, cmodel, model, requests
    step_ms = {}
    for engine, (step, _) in runs.items():
        t_k = _spread(lambda: step(batches[0], labels), iters=3)
        with plain_twin():
            t_p = _spread(lambda: step(batches[0], labels), iters=3)
        step_ms[engine] = t_k[0]
        print(f"train step {engine} {BATCH}x3x{IMAGE}x{IMAGE} bf16: kernel path {_fmt(t_k)}, "
              f"plain path {_fmt(t_p)}, over 5 runs of 3 [{card}]")
    for engine in ("pallas_fused", "pallas", "fourier", "fourier fused_dx"):
        profile_step(engine, runs[engine][0], batches[0], labels, step_ms[engine], card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    runs["fourier"][0](batches[0], labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"train step fourier bf16: peak device memory {peak / 2**30:.3f} GiB, "
          f"{(peak - resident) / 2**30:.3f} GiB above the {resident / 2**30:.3f} GiB resident "
          f"before the step (models and batches of all four runs) [{card}]")

    # 14. K8 vs twin
    worst_fac = compare_spectral(gen, dev, gather="factored")

    # 15. training with the factored gather in bf16, then the f32 reference
    # steps: kernels vs twins, and the factored gather vs the phi gather
    for engine in ("fourier factored", "fourier factored fused_dx"):
        runs[engine] = _train_run(engine, dev, args.seed, batches, labels)
    for kw in (dict(fused_gather="factored"), dict(fused_gather="factored", fused_dx="on")):
        grads = reference_step("fourier", dev, args.seed, batches[0], labels, **kw)[1]
        compare_gathers(grads, phi_grads, f"f32 step {kw} vs fused_bwd='on' (phi gather)")
    del grads, phi_grads

    # 16. K7 vs twin, and its path: fourier_grad_tables + the 'pmsf' gather at
    # the four layers (N=32, bf16), one K7 launch each
    worst_fac["k7"] = compare_idft(gen, dev)
    layer_ops = [_idft_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)[1]
                 for _, s, f, hw in LAYERS]
    k7_path = path_counts(
        "path fourier_grad_tables + tap_gather('pmsf'), 4 layers, N=32 bf16",
        lambda: [xla_engine.tap_gather(fe.fourier_grad_tables(xb, err, 9), mu1, mu2, 9,
                                       table_layout="pmsf")
                 for xb, err, mu1, mu2 in layer_ops], (0, 0, 0, 0, 0, 0, 0, 4, 0))

    # 17. K3 vs twin, and its path: fourier_apply_phi_fused forward and
    # contract_f at the four layers (N=32, bf16), one K3 call each
    worst_fac["k3"] = compare_apply_phi(gen, dev)
    layer_ops = [_apply_phi_inputs(gen, BATCH, s, f, hw, contract_f, torch.bfloat16, dev)[2]
                 + (contract_f,) for _, s, f, hw in LAYERS for contract_f in (False, True)]
    k3_path = path_counts(
        "path fourier_apply_phi_fused forward + contract_f, 4 layers, N=32 bf16",
        lambda: [fe.fourier_apply_phi_fused(x, w, mu1, mu2, 9, contract_f=c)
                 for x, w, mu1, mu2, c in layer_ops], (0, 0, 0, 0, 0, 0, 0, 0, 8))
    del layer_ops

    # 18. timing: K8, K7, K3 per layer and the factored steps
    new = time_new_kernels(gen, dev, card, worst_fac)
    for key, what in (("k8", "K8"), ("k8dx", "K8 dx")):
        ms, plain, _, bound = new[key]
        dev_ms = (f"device time: the kernel {new['k8dev'][0]:.4f} ms, with its operand kernel "
                  f"and sum {new['k8dev'][1]:.4f} ms" if key == "k8" else
                  f"device time of its dx kernel {new['k8dev'][2]:.4f} ms")
        print(f"{what} over the four layers N={BATCH} bf16: kernel with its wrapper {ms:.3f} "
              f"ms ({dev_ms}), bound {bound.ms:.4f} ms ({bound.bound_by}), twin {plain:.3f} "
              f"ms [{card}]")
    print(f"dx kernel over the four layers (K8 dx's 4 launches) N={BATCH} bf16: "
          f"{_dx_line(new['dx'])} [{card}]")
    time_aggregation(gen, dev, card, ks)
    for key, what, lib_what in (("k7", "K7", "one matmul"),
                                ("k3", "K3 (both directions)",
                                 "one bf16 bmm of the products alone (Phi built beforehand)")):
        ms, plain, lib, bound = new[key]
        print(f"{what} over the four layers N={BATCH} bf16: kernel {ms:.3f} ms, bound "
              f"{bound.ms:.4f} ms ({bound.bound_by}), {lib_what} {lib:.4f} ms, twin "
              f"{plain:.3f} ms [{card}]")
    d = new["k3dev"]
    print(f"K3 over the four layers, both directions (8 calls) N={BATCH} bf16, device time: "
          f"the products kernel {d[0]:.4f} ms, the operand building {d[1]:.4f} ms, the closing "
          f"launch {d[2]:.4f} ms, the whole calls {d[3]:.4f} ms [{card}]")
    for engine in ("fourier factored", "fourier factored fused_dx", "fourier"):
        step = runs[engine][0]
        t_k = _spread(lambda: step(batches[0], labels), iters=3)
        with plain_twin():
            t_p = _spread(lambda: step(batches[0], labels), iters=3)
        step_ms[engine] = t_k[0]
        print(f"train step {engine} {BATCH}x3x{IMAGE}x{IMAGE} bf16: kernel path {_fmt(t_k)}, "
              f"plain path {_fmt(t_p)}, over 5 runs of 3 [{card}]")
    profile_step("fourier factored", runs["fourier factored"][0], batches[0], labels,
                 step_ms["fourier factored"], card)

    # 19. K4 and K5 past ks 17: the tiers 33 and 65, in bands of tap rows
    worst_bwd["k4"] = max(worst_bwd["k4"], compare_bands(gen, dev, "K4", 33))
    worst_bwd["k5dx"] = max(worst_bwd["k5dx"], compare_bands(gen, dev, "K5", 33))
    for tier in (33, 65):
        time_aggregation(gen, dev, card, tier)
    for engine in ("pallas ks33", "pallas_fused ks33"):
        _train_run(engine, dev, args.seed, batches, labels)

    # 20. planes wider than a TMA box: K4 and K5 in column strips
    for kernel in ("K4", "K5"):
        worst_bwd["k4" if kernel == "K4" else "k5dx"] = max(
            worst_bwd["k4" if kernel == "K4" else "k5dx"], compare_wide(gen, dev, kernel))
    time_wide(gen, dev, card)
    for engine in ("pallas", "pallas_fused"):
        wide_step(engine, dev, args.seed)

    # 21-23. the other models at G = 4: the CIFAR nets from the repo's
    # artifacts, CIFAR training, DAU-ResNet-18 at full width
    x_train, y_train, x_test, y_test = synthetic_spatial(n=50000)
    more, spatial_logits = cifar_artifacts(dev, card, x_test, y_test)
    for _, counts in cifar_training(dev, args.seed, card, x_train, y_train).values():
        more = _add(more, counts)
    del x_train, x_test
    more = _add(more, resnet(dev, args.seed, card, gen))
    time_model_layers(gen, dev, card)
    print(f"phases 21-23 (G=4): launches {COUNTS} {more}; K1 launched {more[3]} times at G=4, "
          f"K5 {more[0]} times")

    # 24. the bench's configurations
    more = _add(more, bench_configurations(dev, args.seed, card, gen))

    # 25. the examples: train, serve and analyse through them
    more = _add(more, examples(dev, card, spatial_logits))

    # 26. the parallel slice: the sharded step on three meshes, a process a rank
    launches_parallel = parallel(dev, args.seed, card)

    # 27. the probes P1-P9 through their entry points
    probe_rows = probes(dev, card)

    # 28. the one-device step replayed as one CUDA graph, against eager steps
    graph_steps(dev, args.seed, card)

    launches_k5 = launches + runs["pallas_fused"][1][0] + more[0]
    launches_k4 = runs["pallas"][1][1] + more[1]
    launches_k6 = runs["pallas_fused"][1][2] + runs["pallas"][1][2] + more[2]
    launches_k1 = runs["fourier"][1][3] + more[3]
    print(f"chip_smoke: the whole run took {time.perf_counter() - t_run:.1f} s, the build "
          f"included [{card}]")
    launches_k2 = runs["fourier fused_dx"][1][4] + launches_parallel[4]
    launches_k8 = runs["fourier factored"][1][5]
    launches_k8dx = runs["fourier factored fused_dx"][1][6]
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=launches_k5, max_abs_err=max(worst, worst_bwd["k5dx"]),
             ms=k5[0], plain_ms=k5[2], bound_ms=k5_bound.ms,
             bound_by=k5_bound.bound_by, library_ms=k5[3]),
        dict(KERNEL_K6, launches=launches_k6, max_abs_err=worst_bwd["k6"],
             ms=k6_ms, plain_ms=k6_plain, bound_ms=k6_bound.ms, bound_by=k6_bound.bound_by,
             library_ms=k6_lib),
        dict(KERNEL_K4, launches=launches_k4, max_abs_err=worst_bwd["k4"],
             ms=k4_sum, plain_ms=k4_plain, bound_ms=k4_bound.ms, bound_by=k4_bound.bound_by,
             library_ms=k4_lib),
        dict(KERNEL_K1, launches=launches_k1, max_abs_err=worst_spec["k1"],
             ms=spec["k1"], plain_ms=spec["k1_plain"], bound_ms=k1_bound.ms,
             bound_by=k1_bound.bound_by, library_ms=None),
        dict(KERNEL_K2, launches=launches_k2, max_abs_err=worst_spec["k2"],
             ms=spec["k2"], plain_ms=spec["k2_plain"], bound_ms=k2_bound.ms,
             bound_by=k2_bound.bound_by, library_ms=None),
        *(dict(entry, launches=n_launch, max_abs_err=worst_fac[key], ms=new[key][0],
               plain_ms=new[key][1], bound_ms=new[key][3].ms, bound_by=new[key][3].bound_by,
               library_ms=new[key][2])
          for entry, key, n_launch in ((KERNEL_K8, "k8", launches_k8),
                                       (KERNEL_K8_DX, "k8dx", launches_k8dx),
                                       (KERNEL_K7, "k7", k7_path[7]),
                                       (KERNEL_K3, "k3", k3_path[8]))),
        # the dx kernel alone over the four layers (K8 dx's launches), its
        # launches those of K2 and K8 dx on their steps; the bmm of its
        # contraction alone as the library call
        dict(KERNEL_DX, launches=launches_k2 + launches_k8dx,
             max_abs_err=max(worst_spec["dx"], worst_fac["dx"]), ms=new["dx"][0],
             plain_ms=new["dx"][2], bound_ms=new["dx"][1], bound_by="bytes",
             library_ms=new["dx"][3]),
        *(_probe_entry(row) for row in probe_rows)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# phase 28: the runs of TRAIN_RUNS whose step is replayed; the trace's
# hand-kernel classes (CATEGORIES' first six, first match wins) and the
# launch counters (COUNTS' order) whose launches run a kernel of each
GRAPH_RUNS = ("pallas_fused", "pallas", "fourier", "fourier fused_dx", "fourier factored",
              "fourier factored fused_dx")
GRAPH_CLASSES = {"K5 fused_forward_kernel": (0,), "K4 aggregate_kernel": (1,),
                 "K6 grad_tables_kernel": (2,), "K8 spectral_grads_kernel<FactoredGather>": (5, 6),
                 "K1/K2 spectral_grads_kernel<PhiGather>": (3, 4),
                 "K2/K8 spectral_dx_kernel": (4, 6)}


def _graph_run(engine, dev, seed, batches, labels, cuda_graph):
    """STEPS SGD steps of the run `engine` of TRAIN_RUNS from the seed's
    weights: (model, step, losses, parameters, gradients, BatchNorm
    statistics)."""
    kw, _ = TRAIN_RUNS[engine]
    model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(seed), **kw)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                           cuda_graph=cuda_graph)
    losses = torch.stack([step(x, labels) for x in batches]).float()
    torch.cuda.synchronize()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return model, step, losses, params, grads, _stats(model)


def _held_like_eager(tag, a, b, c):
    """c (graphed) against a (eager), tensor by tensor: bit for bit where
    the second eager run b is, else within b's distance from a. Returns how
    many were bit for bit."""
    if set(a) != set(c):
        raise AssertionError(f"{tag}: graphed tensors {sorted(set(c) ^ set(a))} differ")
    same = 0
    for key in a:
        ref, twin, got = a[key].float(), b[key].float(), c[key].float()
        if torch.equal(ref, twin):
            if not torch.equal(ref, got):
                raise AssertionError(f"{tag}: {key} differs from two bitwise-equal eager runs")
            same += 1
        elif float((got - ref).abs().max()) > float((twin - ref).abs().max()):
            raise AssertionError(f"{tag}: {key} differs from eager by more than eager from "
                                 f"eager: {float((got - ref).abs().max())} > "
                                 f"{float((twin - ref).abs().max())}")
    return same


def _traced_launches(fn):
    """(device events by name, with their count) of one call of fn under
    `torch.profiler`, and the launch counters' delta over it."""
    before = _counts()
    with trace(host=False) as prof:
        fn()
    got = tuple(a - b for a, b in zip(_counts(), before))
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}, got


def _hand_launches(events):
    out = {}
    for name, n in events.items():
        cls = next((c for c, frags in CATEGORIES[:6] if any(fr in name for fr in frags)), None)
        if cls is not None:
            out[cls] = out.get(cls, 0) + n
    return out


def graph_steps(dev, seed, card):
    """Phase 28: the one-device step replayed as one CUDA graph against eager
    steps from the same weights and batches, per run of GRAPH_RUNS."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 28)
    batches = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
               for _ in range(STEPS)]
    labels = torch.randint(0, 1000, (BATCH,), generator=gen).to(dev)
    for engine in GRAPH_RUNS:
        eager = _graph_run(engine, dev, seed, batches, labels, False)
        twin = _graph_run(engine, dev, seed, batches, labels, False)[2:]
        graphed = _graph_run(engine, dev, seed, batches, labels, True)
        counts = dict(graphed[1].counts)
        if counts != {"first_call": 1, "captures": 1, "replays": STEPS - 2}:
            raise AssertionError(f"graph {engine}: calls {counts}, failures "
                                 f"{list(graphed[1].failures.values())}")
        same = sum(_held_like_eager(f"graph {engine} {what}", e, t, g)
                   for what, e, t, g in zip(("losses", "parameters", "gradients", "statistics"),
                                            ({"loss": eager[2]}, *eager[3:]),
                                            ({"loss": twin[0]}, *twin[1:]),
                                            ({"loss": graphed[2]}, *graphed[3:])))
        total = 1 + sum(len(t) for t in graphed[3:])
        replays = graphed[1].counts["replays"]
        for taken in range(1, 4):
            e_events, e_counted = _traced_launches(lambda: eager[1](batches[0], labels))
            r_events, r_counted = _traced_launches(lambda: graphed[1](batches[0], labels))
            want = {c: sum(e_counted[i] for i in idx) for c, idx in GRAPH_CLASSES.items()}
            want = {c: n for c, n in want.items() if n}
            if _hand_launches(e_events) == want == _hand_launches(r_events):
                break
        else:
            raise AssertionError(f"graph {engine}: hand-kernel launches in the traces: eager "
                                 f"{_hand_launches(e_events)}, replay {_hand_launches(r_events)},"
                                 f" counted {want}")
        if r_counted != e_counted:
            raise AssertionError(f"graph {engine}: a replay advanced the counters by "
                                 f"{r_counted}, an eager step by {e_counted}")
        if graphed[1].counts["replays"] != replays + taken:
            raise AssertionError(f"graph {engine}: a traced call did not replay: "
                                 f"{dict(graphed[1].counts)}")
        diff = {k: (e_events.get(k, 0), r_events.get(k, 0))
                for k in set(e_events) | set(r_events) if e_events.get(k, 0) != r_events.get(k, 0)}
        t_e = _spread(lambda: eager[1](batches[0], labels), iters=3)
        t_r = _spread(lambda: graphed[1](batches[0], labels), iters=3)
        print(f"graph {engine} N={BATCH} bf16: {STEPS} steps {counts}; {same} of {total} tensors "
              f"bit for bit as eager, the rest within eager's own distance; hand kernels in the "
              f"replay's trace {_hand_launches(r_events)} = eager's = counted; device events "
              f"eager {sum(e_events.values())}, replay {sum(r_events.values())}; step eager "
              f"{_fmt(t_e)}, replayed {_fmt(t_r)} over 5 runs of 3 [{card}]")
        for k, (a, b) in sorted(diff.items()):
            print(f"  graph {engine} device events eager {a} -> replay {b}: {k[:110]}")
        del eager, twin, graphed
        torch.cuda.empty_cache()
    print(f"phase 28 (CUDA graph): {len(GRAPH_RUNS)} runs, {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


def probes(dev, card):
    """Phase 27: the probes P1-P9 at the JAX probes' full shapes, through
    `mosaic_probe.run` and `pallas_ladder.run` (each probe kernel held
    against its twin there; a failing probe prints FAIL and fails the
    phase), with every launch counter of the probes' wrappers set to 0
    just before and read just after. Returns the probes' rows."""
    t0 = time.perf_counter()
    for kernel in probes_pkg.KERNELS:
        kernel.launches = 0
    ok_mosaic, rows = mosaic_probe.run(device=dev)
    ok_ladder, more = pallas_ladder.run(device=dev)
    counts = {kernel.__name__: kernel.launches for kernel in probes_pkg.KERNELS}
    if not (ok_mosaic and ok_ladder):
        raise AssertionError("phase 27: a probe failed (its FAIL line above)")
    rows += more
    idle = [name for name, n in counts.items() if not n]
    if idle or any(not row["launches"] for row in rows):
        raise AssertionError(f"phase 27: kernels not launched by the probes: {idle}, {counts}")
    print(f"phase 27 (the probes P1-P9): {len(rows)} timed rows, launches {counts}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return rows


def _probe_entry(row):
    """The kernels line's entry of one probe row (times: medians)."""
    med = lambda s: None if s is None else s[0]  # noqa: E731
    return dict(name=f"{row['kernel'].__name__} as {row['probe']} ({row['label']})",
                route="cuda", source=row["source"], replaces=row["replaces"],
                launches=row["launches"], max_abs_err=row["err"], ms=med(row["ms"]),
                plain_ms=med(row["plain_ms"]), bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=med(row["library_ms"]))


def compare_bands(gen, dev, kernel, ks):
    """Phase 19: K4 or K5 at kernel size ks (bands of tap rows) against its
    twin at each layer shape and its dx shape (N=4), f32 and bf16, bounds as
    in phase 6; returns the largest |error|."""
    worst = 0.0
    filters = gaussian_filters(0.5, size=9, device=dev)
    for name, s, f, hw in LAYERS:
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x, w, mu1, mu2 = _layer_inputs(gen, 4, s, f, hw, dtype, dev)
            e, wt, m1, m2 = _dx_inputs(gen, 4, s, f, hw, dtype, dev)
            for way, args, filt in (("forward", (x, w, mu1, mu2), filters["w"]),
                                    ("dx", (e, wt, m1, m2), filters["error"])):
                if kernel == "K4":
                    plan = kfwd.aggregate_plan(hw, hw, ks)
                    got = kfwd.aggregate_forward(*args, ks)
                    want = kfwd.aggregate_forward_plain(args[0].float(), *args[1:], ks)
                else:
                    plan = kfwd.fused_plan(hw, hw, ks, 9, dtype)
                    got = kfwd.dau_forward_fused(*args, filt, ks)
                    want = kfwd.dau_forward_fused_plain(args[0].float(), *args[1:], filt, ks)
                if got.dtype != dtype:
                    raise AssertionError(f"{kernel} ks={ks} {name} {way}: output is {got.dtype}")
                worst = max(worst, _check_err(
                    f"{kernel} ks={ks} ({plan['bands']} bands of {plan['kyb']} tap rows) {way} "
                    f"{name} {str(dtype)[6:]}", got, want, bound))
    return worst


def time_aggregation(gen, dev, card, ks):
    """Phase 18 (ks=9) and 19 (ks 33, 65): K4 and K5 per layer at N=32 bf16,
    forward and dx shapes, with the wrapper (CUDA events) and the kernel
    alone (device time, `torch.profiler`); prints each and the sums over the
    8 launches of a step."""
    filters = gaussian_filters(0.5, size=9, device=dev)
    sums = {k: [0.0, 0.0] for k in ("K4", "K5")}
    iters = 10 if ks <= 9 else 3
    for name, s, f, hw in LAYERS:
        x, w, mu1, mu2 = _layer_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        e, wt, m1, m2 = _dx_inputs(gen, BATCH, s, f, hw, torch.bfloat16, dev)
        cols = []
        for way, args, filt in (("forward", (x, w, mu1, mu2), filters["w"]),
                                ("dx", (e, wt, m1, m2), filters["error"])):
            for kernel, fn, frag in (
                    ("K4", lambda: kfwd.aggregate_forward(*args, ks), "aggregate_kernel"),
                    ("K5", lambda: kfwd.dau_forward_fused(*args, filt, ks),
                     "fused_forward_kernel")):
                t = _cuda_ms(fn, iters=iters)
                d = _device_ms(fn, frag, iters=iters)[0]
                sums[kernel][0] += t
                sums[kernel][1] += d
                cols.append(f"{kernel} {way} {t:.3f} ms (kernel {d:.4f})")
        print(f"layer {name} ks={ks} N={BATCH} bf16: {'; '.join(cols)} [{card}]")
        del x, e
    plan = kfwd.aggregate_plan(27, 27, ks), kfwd.fused_plan(27, 27, ks, 9, torch.bfloat16)
    for kernel, (ms, dev_ms) in sums.items():
        print(f"{kernel} ks={ks} over the 8 launches of a step (four forward, four dx shapes) "
              f"N={BATCH} bf16: with its wrapper {ms:.3f} ms, the kernel alone {dev_ms:.4f} ms "
              f"device time (conv2's plan: {plan[kernel == 'K5']['bands']} bands of "
              f"{plan[kernel == 'K5']['kyb']} tap rows) [{card}]")


# phase 20: (N, S, F, H) of the wide-plane checks, and the timed planes
WIDE = (2, 9, 70, 5)
WIDE_TIMED = ((24, 300, 48, 150), (24, 640, 96, 160))


def compare_wide(gen, dev, kernel):
    """Phase 20: K4 or K5 on planes wider than a TMA box (column strips)
    against its twin at W = 300 and 640, ks 3, 9 and 33, f32 and bf16;
    returns the largest |error|."""
    n, s, f, h = WIDE
    filt = gaussian_filters(0.5, size=9, device=dev)["w"]
    worst = 0.0
    for w in (300, 640):
        for ks in (3, 9, 33):
            for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
                x = torch.rand((n, s, h, w), generator=gen).to(dev, dtype)
                wt = (torch.randn((s, G, f), generator=gen) * 0.1).to(dev, dtype)
                lim = ks // 2 - 0.01
                mu1, mu2 = (torch.rand((2, s, G, f), generator=gen) * 2 * lim - lim).to(dev, dtype)
                if kernel == "K4":
                    plan = kfwd.aggregate_plan(h, w, ks)
                    got = kfwd.aggregate_forward(x, wt, mu1, mu2, ks)
                    want = kfwd.aggregate_forward_plain(x.float(), wt, mu1, mu2, ks)
                else:
                    plan = kfwd.fused_plan(h, w, ks, 9, dtype)
                    got = kfwd.dau_forward_fused(x, wt, mu1, mu2, filt, ks)
                    want = kfwd.dau_forward_fused_plain(x.float(), wt, mu1, mu2, filt, ks)
                if got.dtype != dtype or plan["strips"] < 2:
                    raise AssertionError(f"{kernel} W={w} ks={ks}: {got.dtype}, {plan['strips']} "
                                         "strips")
                worst = max(worst, _check_err(
                    f"{kernel} {h}x{w} ks={ks} ({plan['strips']} strips of {plan['wc']} "
                    f"columns, {plan['bands']} bands) {str(dtype)[6:]}", got, want, bound))
    return worst


def time_wide(gen, dev, card):
    """Phase 20: K4's and K5's kernel times (device time, `torch.profiler`)
    at N=8, S=64, F=128, ks 9, bf16 on the wide planes and on planes of the
    same pixel count with one strip."""
    filt = gaussian_filters(0.5, size=9, device=dev)["w"]
    for plane in WIDE_TIMED:
        cols = []
        for h, w in (plane[:2], plane[2:]):
            x, wt, mu1, mu2 = _layer_inputs(gen, 8, 64, 128, 1, torch.bfloat16, dev)
            x = torch.rand((8, 64, h, w), generator=gen).to(dev, torch.bfloat16)
            for kernel, fn, frag, plan in (
                    ("K4", lambda: kfwd.aggregate_forward(x, wt, mu1, mu2, 9), "aggregate_kernel",
                     kfwd.aggregate_plan(h, w, 9)),
                    ("K5", lambda: kfwd.dau_forward_fused(x, wt, mu1, mu2, filt, 9),
                     "fused_forward_kernel", kfwd.fused_plan(h, w, 9, 9, torch.bfloat16))):
                d = _device_ms(fn, frag)[0]
                cols.append(f"{kernel} {h}x{w} ({plan['strips']} strips, {plan['bands']} bands) "
                            f"{d:.4f} ms")
        print(f"wide plane N=8 S=64 F=128 ks=9 bf16, kernel device time: {'; '.join(cols)} "
              f"[{card}]")


def wide_step(engine, dev, seed):
    """Phase 20: one SGD step of a small net (3x3 conv, two DAU layers,
    pool, linear) on 2x32x24x300 through `make_train_step` on `engine`:
    2 forward and 2 dx launches of K4 ('pallas') or K5 ('pallas_fused') and
    2 K6; a finite loss and a finite gradient for every parameter."""
    from dau_convnet_tpu_torch.nn import DAUConv2d
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(32, 32, 3, padding=1), torch.nn.ReLU(),
        DAUConv2d(32, 32, (2, 1), 9, engine=engine, device=dev, generator=gen), torch.nn.ReLU(),
        DAUConv2d(32, 16, (2, 1), 9, engine=engine, device=dev, generator=gen),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(), torch.nn.Linear(16, 10)).to(dev)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    x = torch.rand((2, 32, 24, 300), generator=gen).to(dev)
    kernel = 0 if engine == "pallas_fused" else 1
    want = tuple((4 if i == kernel else 2 if i == 2 else 0) for i in range(9))
    loss = []
    got = path_counts(f"wide step {engine} 2x32x24x300",
                      lambda: loss.append(step(x, torch.tensor([1, 7], device=dev))), want)
    if not torch.isfinite(loss[0]):
        raise AssertionError(f"wide step {engine}: loss {float(loss[0])}")
    for name, p in model.named_parameters():
        if not name.endswith(".sigma") and (p.grad is None or not torch.isfinite(p.grad).all()):
            raise AssertionError(f"wide step {engine}: {name} has no finite gradient")
    print(f"wide step {engine}: loss {float(loss[0]):.5f}, every gradient finite")
    return got


def _train_run(engine, dev, seed, batches, labels):
    """Phase 7/12 for one run of TRAIN_RUNS: returns (step, launch counts)."""
    model, step, counts, moved = train(engine, dev, seed, batches, labels)
    trainable = [k for k, p in model.named_parameters() if not k.endswith(".sigma")]
    still = [k for k in trainable if k not in moved]
    print(f"train {engine}: {STEPS} bf16 steps of {BATCH}x3x{IMAGE}x{IMAGE}, launches "
          f"{COUNTS} {counts}; {len(moved)} of {len(trainable)} trainable parameter "
          f"tensors moved" + (f"; unmoved (every update below half a bf16 ulp): {still}"
                              if still else ""))
    return step, counts


# phases 21-23: the other models at G = 4 (dau_units (2, 2)). Launches per
# request or step in COUNTS' order, derived from the op: each DAU layer
# runs one forward aggregation (K5 on 'pallas_fused', K4 on 'pallas'); in
# training each layer also runs one K6 and, where its input needs a
# gradient, one dx aggregation; CIFAR conv1's input is the image, so of
# its three layers two run a dx pass. 'auto' in bf16 resolves to 'fourier',
# whose forward and dx run no kernel and whose unit gradients come from K1
# at every layer (the gate sends G >= 4 to K1 at any bin count).
CIFAR_ARTIFACTS = (("docs/spatial_dau_4000_params.npz", "DAUCifarNet"),
                   ("docs/spatial_conv_2500_params.npz", "ConvCifarNet"))
CIFAR_SERVE = {"xla": (0, 0, 0, 0, 0, 0, 0, 0, 0), "pallas": (0, 3, 0, 0, 0, 0, 0, 0, 0),
               "pallas_fused": (3, 0, 0, 0, 0, 0, 0, 0, 0), "fourier": (0, 0, 0, 0, 0, 0, 0, 0, 0)}
CIFAR_REQUEST, CIFAR_TEST = 125, 500
CIFAR_BATCH, CIFAR_LR = 128, 1e-3
CIFAR_TRAIN = {
    "auto": (dict(), (0, 0, 0, 3, 0, 0, 0, 0, 0)),
    "pallas_fused": (dict(engine="pallas_fused"), (5, 0, 3, 0, 0, 0, 0, 0, 0)),
    "pallas": (dict(engine="pallas"), (0, 5, 3, 0, 0, 0, 0, 0, 0)),
    "auto sigma": (dict(dau_sigma_trainable=True), (0, 0, 0, 3, 0, 0, 0, 0, 0)),
    "pallas_fused sigma": (dict(engine="pallas_fused", dau_sigma_trainable=True),
                           (5, 0, 3, 0, 0, 0, 0, 0, 0)),
}
# DAU-ResNet-18: 16 DAU layers, each one's input needing a gradient
RESNET_BATCH, RESNET_IMAGE, RESNET_LR = 32, 224, 1e-4
RESNET_SERVE = {"pallas_fused": (16, 0, 0, 0, 0, 0, 0, 0, 0), "auto": (0, 0, 0, 0, 0, 0, 0, 0, 0)}
RESNET_TRAIN = {"auto": (dict(), (0, 0, 0, 16, 0, 0, 0, 0, 0)),
                "pallas_fused": (dict(engine="pallas_fused"), (32, 0, 16, 0, 0, 0, 0, 0, 0))}


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _per_call(tag, fn, calls, want):
    """Run fn(c) for each c of `calls` with the counters at 0, checking the
    launches of each call against `want`; returns the outputs and the
    counts."""
    _zero_counts()
    out = []
    for i, c in enumerate(calls):
        before = _counts()
        out.append(fn(c))
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
        if got != want:
            raise AssertionError(f"{tag} call {i}: launches {COUNTS} {got}, want {want}")
    return out, _counts()


# (name, N, S, F, H=W) of the other models' DAU layers as their phases
# run them: the CIFAR nets at N=128 (conv1's S = 3), DAU-ResNet-18 at N=32
# (one layer per stage, its planes and widths; the strided first layers
# compute at their input's plane)
MODEL_LAYERS = (("cifar conv1", 128, 3, 96, 32), ("cifar conv2", 128, 96, 96, 16),
                ("cifar conv3", 128, 96, 192, 8), ("resnet stage0", 32, 64, 64, 56),
                ("resnet stage1", 32, 128, 128, 28), ("resnet stage2", 32, 256, 256, 14),
                ("resnet stage3", 32, 512, 512, 7))


def time_model_layers(gen, dev, card):
    """Per layer of MODEL_LAYERS at G = 4 in bf16: K5 at kb 9 (and 17, a
    trainable sigma's filter, at the CIFAR layers), K4, K6 and K1 checked
    against their twins on the same inputs (K5, K4 and K1 within
    1e-2*max|twin|, K6 within 1e-4, the bounds of phases 1, 6 and 10), then
    timed: K5 against its twin and the two-call library chain, K4 and K6
    against one `conv2d` each (as in phase 9), and K1 against its twin; K5
    and K4 also alone (device time); each row says where a kernel with its
    wrapper loses to its library call. Returns {kernel: [ms, library ms, device ms of K5's and K4's
    kernel alone]} summed over the layers (K5 at kb 9)."""
    filters = {kb: gaussian_filters(sigma, size=kb, device=dev)["w"]
               for kb, sigma in ((9, 0.5), (17, 1.6))}
    ks = DAUConvSettings().synth_kernel_size
    sums = {k: [0.0, 0.0, 0.0] for k in ("K5", "K4", "K6", "K1")}
    conv = torch.nn.functional.conv2d
    for name, n, s, f, hw in MODEL_LAYERS:
        x = torch.rand((n, s, hw, hw), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((s, 4, f), generator=gen) * 0.1).to(dev, torch.bfloat16)
        mu1, mu2 = (torch.rand((2, s, 4, f), generator=gen) * 7.98 - 3.99).to(dev, torch.bfloat16)
        cols = []
        for kb in ((9, 17) if name.startswith("cifar") else (9,)):
            _check_err(f"K5 {name} kb={kb} bf16",
                       kfwd.dau_forward_fused(x, w, mu1, mu2, filters[kb], ks),
                       kfwd.dau_forward_fused_plain(x.float(), w, mu1, mu2, filters[kb], ks), 1e-2)
            t = time_k5(x, w, mu1, mu2, filters[kb], ks, Bounds())
            d = _device_ms(lambda: kfwd.dau_forward_fused(x, w, mu1, mu2, filters[kb], ks),
                           "fused_forward_kernel")[0]
            if kb == 9:
                sums["K5"] = [sums["K5"][0] + t[0], sums["K5"][1] + t[3], sums["K5"][2] + d]
            cols.append(f"K5 kb={kb} {t[0]:.3f} ms, kernel alone {d:.4f} (twin {t[2]:.3f}, "
                        f"chain {t[3]:.3f}{', LOSES to the chain' if t[0] > t[3] else ''}; "
                        f"{kfwd.fused_cluster_size(f)}-block clusters)")
        _check_err(f"K4 {name} bf16", kfwd.aggregate_forward(x, w, mu1, mu2, ks),
                   kfwd.aggregate_forward_plain(x.float(), w, mu1, mu2, ks), 1e-2)
        t_k = _cuda_ms(lambda: kfwd.aggregate_forward(x, w, mu1, mu2, ks))
        d = _device_ms(lambda: kfwd.aggregate_forward(x, w, mu1, mu2, ks), "aggregate_kernel")[0]
        kern = xla_engine.synthesize_kernel(w, mu1, mu2, ks).transpose(0, 1).contiguous()
        t_l = _cuda_ms(lambda: conv(x, kern, padding=ks // 2))
        sums["K4"] = [sums["K4"][0] + t_k, sums["K4"][1] + t_l, sums["K4"][2] + d]
        cols.append(f"K4 {t_k:.3f} ms, kernel alone {d:.4f} (conv2d {t_l:.3f}"
                    f"{', LOSES' if t_k > t_l else ''})")
        xb, err = _tables_inputs(gen, n, s, f, hw, torch.bfloat16, dev)
        _check_err(f"K6 {name} bf16 M={M}", kbwd.grad_tables(xb, err, ks),
                   kbwd.grad_tables_plain(xb, err, ks), 1e-4)
        t_k = _cuda_ms(lambda: kbwd.grad_tables(xb, err, ks))
        lhs = xb.transpose(1, 2).reshape(M * s, n, hw, hw)
        rhs = err.transpose(0, 1).contiguous()
        t_l = _cuda_ms(lambda: conv(lhs, rhs, padding=ks // 2))
        sums["K6"][0] += t_k
        sums["K6"][1] += t_l
        cols.append(f"K6 {t_k:.3f} ms (conv2d {t_l:.3f}{', LOSES' if t_k > t_l else ''})")
        del x, xb, err, lhs, rhs, kern
        args, kw, _, _ = _spectral_inputs(gen, n, s, f, hw, torch.bfloat16, dev, g=4)
        _check_err(f"K1 {name} G=4 bf16 B={kw['p1b'] * kw['rbb']}",
                   kfb.fused_spectral_grads(*args, **kw),
                   kfb.fused_spectral_grads_plain(*args, **kw), 1e-2)
        t_k = _cuda_ms(lambda: kfb.fused_spectral_grads(*args, **kw))
        t_p = _cuda_ms(lambda: kfb.fused_spectral_grads_plain(*args, **kw), iters=3)
        sums["K1"][0] += t_k
        cols.append(f"K1 B={kw['p1b'] * kw['rbb']} {t_k:.3f} ms (twin {t_p:.3f})")
        del args
        print(f"layer {name} N={n} {s}->{f} {hw}x{hw} G=4 bf16: {'; '.join(cols)} [{card}]")
    print(f"over the {len(MODEL_LAYERS)} layer shapes of the other models, G=4 bf16: "
          + "; ".join(f"{k} {v[0]:.3f} ms" + (f", kernel alone {v[2]:.4f}" if v[2] else "")
                      + (f" (library {v[1]:.3f})" if v[1] else "") for k, v in sums.items())
          + f" [{card}]")
    return sums


def cifar_artifacts(dev, card, x_test, y_test):
    """Phase 21: the spatial artifacts in eval mode, f32, on the recorded
    500-image test slice in requests of 125: DAUCifarNet through each engine
    of CIFAR_SERVE, ConvCifarNet through plain torch ops. Each engine's
    logits within 1e-3*max|logits| of its plain twins' and of the 'xla'
    engine's, top-1 in [0.42, 0.58] and pair accuracy >= 0.92 (the bounds
    of tests/test_models.py); request times. Returns the launch counts and
    the DAU artifact's 'fourier' logits (phase 25 holds analyze_spatial's
    predictions against them)."""
    x = torch.from_numpy(x_test[:CIFAR_TEST]).to(dev)
    y = torch.from_numpy(y_test[:CIFAR_TEST]).to(dev).long()
    requests = x.split(CIFAR_REQUEST)
    total = (0,) * 9
    kept = None
    for path, kind in CIFAR_ARTIFACTS:
        state = params_from_flax(load_params_npz(str(ROOT / path)))
        ref = None
        for engine in (CIFAR_SERVE if kind == "DAUCifarNet" else ("xla",)):
            if kind == "DAUCifarNet":
                net = DAUCifarNet(train=False, engine=engine, device=dev)
                tag = f"{kind} {engine}"
            else:
                net = ConvCifarNet(train=False, device=dev)
                tag = f"{kind} (plain torch ops)"
            net.load_state_dict(state)
            with torch.inference_mode():
                out, counts = _per_call(f"artifact {tag}", net, requests, CIFAR_SERVE[engine])
                logits = torch.cat(out)
                with plain_twin():
                    plain = torch.cat([net(r) for r in requests])
                t = _spread(lambda: net(requests[0]))
            total = _add(total, counts)
            if logits.shape != (CIFAR_TEST, 10) or not torch.isfinite(logits).all():
                raise AssertionError(f"artifact {tag}: bad logits {tuple(logits.shape)}")
            ref = logits if ref is None else ref
            errs = [float((logits - want).abs().max()) for want in (plain, ref)]
            scales = [float(want.abs().max()) for want in (plain, ref)]
            pred = logits.argmax(-1)
            top1 = float((pred == y).float().mean())
            pair = float(((pred % 5) == (y % 5)).float().mean())
            print(f"artifact {path} {tag} f32: top-1 {top1:.4f}, pair {pair:.4f}; vs plain "
                  f"twins max|dlogits|={errs[0]:.3e}, vs xla {errs[1]:.3e} (bounds "
                  f"{1e-3 * scales[0]:.3e}, {1e-3 * scales[1]:.3e}); launches {COUNTS} {counts}; "
                  f"request of {CIFAR_REQUEST}x3x32x32 {_fmt(t)} [{card}]")
            if not (errs[0] <= 1e-3 * scales[0] and errs[1] <= 1e-3 * scales[1]):
                raise AssertionError(f"artifact {tag}: logits disagree")
            if not (0.42 <= top1 <= 0.58 and pair >= 0.92):
                raise AssertionError(f"artifact {tag}: top-1 {top1}, pair {pair} out of bounds")
            if tag == "DAUCifarNet fourier":
                kept = logits
            del net
    return total, kept


def _check_model_engines(model, engine, g):
    engines = {m.cfg.engine for m in model.modules() if isinstance(m, DAUConv2d)}
    units = {m.weights.shape[2] for m in model.modules() if isinstance(m, DAUConv2d)}
    if engines != {engine} or units != {g}:
        raise AssertionError(f"DAU layers on {engines} with G {units}, want {engine}, G={g}")


def cifar_training(dev, seed, card, x_train, y_train):
    """Phase 22: DAUCifarNet trains 3 bf16 SGD steps (lr 1e-3) of 128 images
    per run of CIFAR_TRAIN with `run_steps`' checks and one more under
    `checked_kernels`; then one f32 step per
    kernel engine through the kernels and the twins (`reference_grads`);
    step times and the device time by kernel class of the 'auto' and
    'pallas_fused' steps. Returns {run: (step, counts)} and the first
    batch."""
    data = [(torch.from_numpy(x_train[i * CIFAR_BATCH:(i + 1) * CIFAR_BATCH]).to(dev),
             torch.from_numpy(y_train[i * CIFAR_BATCH:(i + 1) * CIFAR_BATCH]).to(dev).long())
            for i in range(STEPS)]
    runs = {}
    for tag, (kw, want) in CIFAR_TRAIN.items():
        model = DAUCifarNet(dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(seed), **kw)
        _check_model_engines(model, kw.get("engine", "fourier"), 4)
        blur = model.dau_conv2.cfg.blur_size
        step, counts, moved = run_steps(f"cifar {tag}", model, data, want, CIFAR_LR)
        with checked_kernels(f"cifar {tag} bf16 step"):
            step(*data[0])
        runs[tag] = (step, counts)
        print(f"train cifar {tag}: {STEPS} bf16 steps of {CIFAR_BATCH}x3x32x32, G=4, blur "
              f"{blur}x{blur}, launches {COUNTS} {counts}; {len(moved)} parameter tensors "
              f"moved, BatchNorm statistics moved")
    for engine, kw in (("fourier", {}), ("pallas_fused", {}), ("pallas", {}),
                       ("fourier", dict(dau_sigma_trainable=True)),
                       ("pallas_fused", dict(dau_sigma_trainable=True))):
        model = DAUCifarNet(engine=engine, device=dev,
                            generator=torch.Generator().manual_seed(seed), **kw)
        reference_grads(f"cifar {engine} {kw}", model, *data[0], backward_only=True)
    for tag in CIFAR_TRAIN:
        step = runs[tag][0]
        t = _spread(lambda: step(*data[0]), iters=3)
        print(f"train step cifar {tag} {CIFAR_BATCH}x3x32x32 bf16: {_fmt(t)} over 5 runs of 3 "
              f"[{card}]")
        if tag in ("auto", "pallas_fused"):
            profile_step(f"cifar {tag}", step, *data[0], t[0], card)
    return runs


def resnet(dev, seed, card, gen):
    """Phase 23: DAU-ResNet-18 at full width (64, G = 4, 1,000 classes) in
    bf16 on 32x3x224x224: 3 requests each on 'pallas_fused' (16 K5 per
    request, some on K5's branch without a cluster) and 'auto' (->
    fourier), then 3 SGD steps (lr 1e-4) each with `run_steps`' checks;
    one 'pallas_fused' request and one more step per run under
    `checked_kernels`;
    request and step times (median of 5 with min and max) and the device
    time by kernel class of each step. Returns the launch counts."""
    requests = [torch.rand((RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE), generator=gen).to(dev)
                for _ in range(REQUESTS)]
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen).to(dev)
    total = (0,) * 9
    for engine, want in RESNET_SERVE.items():
        model = DAUResNet(dtype=torch.bfloat16, device=dev, train=False,
                          generator=torch.Generator().manual_seed(seed),
                          **({} if engine == "auto" else dict(engine=engine)))
        _check_model_engines(model, "fourier" if engine == "auto" else engine, 4)
        clusterless = kfwd.dau_forward_fused.launches_clusterless
        with torch.inference_mode():
            out, counts = _per_call(f"resnet serve {engine}", model, requests, want)
            clusterless = kfwd.dau_forward_fused.launches_clusterless - clusterless
            t = _spread(lambda: model(requests[0]))
        total = _add(total, counts)
        for y in out:
            if y.shape != (RESNET_BATCH, 1000) or not torch.isfinite(y.float()).all():
                raise AssertionError(f"resnet serve {engine}: bad logits")
        if engine == "pallas_fused" and not clusterless:
            raise AssertionError("resnet serve: no K5 launch took the branch without a cluster")
        with torch.inference_mode(), checked_kernels(f"resnet serve {engine} bf16 request"):
            model(requests[0])
        print(f"serving DAU-ResNet-18 {engine} {RESNET_BATCH}x3x{RESNET_IMAGE}x{RESNET_IMAGE} "
              f"bf16: logits finite, launches {COUNTS} {counts} ({clusterless} of them K5 "
              f"without a cluster); request {_fmt(t)} [{card}]")
        del model, out
    for engine, (kw, want) in RESNET_TRAIN.items():
        model = DAUResNet(dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(seed), **kw)
        step, counts, moved = run_steps(f"resnet {engine}", model,
                                        [(x, labels) for x in requests], want, RESNET_LR)
        total = _add(total, counts)
        with checked_kernels(f"resnet {engine} bf16 step"):
            step(requests[0], labels)
        t = _spread(lambda: step(requests[0], labels), iters=3)
        print(f"train DAU-ResNet-18 {engine}: {STEPS} bf16 steps of {RESNET_BATCH}x3x"
              f"{RESNET_IMAGE}x{RESNET_IMAGE}, launches {COUNTS} {counts}; {len(moved)} "
              f"parameter tensors moved; step {_fmt(t)} over 5 runs of 3 [{card}]")
        profile_step(f"resnet18 {engine}", step, requests[0], labels, t[0], card)
        del model, step
    return total


# launches per bf16 step (COUNTS) of the bench's variants, by (variant,
# engine): 'auto' resolves to fourier, whose gate fuses a layer at <= 256
# bins or G >= 4 (the small variant's one unit is rounded to G = 2, so
# conv2's 496 bins stay unfused as in the default variant)
BENCH_STEPS = {
    ("small", "auto"): (0, 0, 0, 3, 0, 0, 0, 0, 0),
    ("small", "pallas_fused"): (8, 0, 4, 0, 0, 0, 0, 0, 0),
    ("large", "auto"): (0, 0, 0, 4, 0, 0, 0, 0, 0),
    ("large", "pallas_fused"): (8, 0, 4, 0, 0, 0, 0, 0, 0),
}
# launches per step of the bench's layer cell, by engine
BENCH_LAYER = {"pallas": (0, 2, 1, 0, 0, 0, 0, 0, 0),
               "pallas_fused": (2, 0, 1, 0, 0, 0, 0, 0, 0),
               "fourier": (0, 0, 0, 1, 0, 0, 0, 0, 0)}
# steps of the memtest and the launches of each (one K1 at 60 bins, G = 2)
MEMTEST_STEPS, MEMTEST_WANT = 20, (0, 0, 0, 1, 0, 0, 0, 0, 0)


def _finite(tag, tensors):
    if not all(bool(torch.isfinite(t.float()).all()) for t in tensors):
        raise AssertionError(f"{tag}: a tensor is not finite")


def _checked_steps(tag, step, carry, steps, want):
    """`steps` chained steps of a bench layer cell, the first under
    `checked_kernels`, each launching `want` (COUNTS); returns the carry and
    the counts."""
    _zero_counts()
    for i in range(steps):
        before = _counts()
        with checked_kernels(f"{tag} step") if i == 0 else contextlib.nullcontext():
            carry = step(carry)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
        if got != want:
            raise AssertionError(f"{tag} step {i}: launches {COUNTS} {got}, want {want}")
    _finite(tag, carry)
    return carry, _counts()


def bench_configurations(dev, seed, card, gen):
    """Phase 24: the configurations of `python -m dau_convnet_tpu_torch.bench`
    that no earlier phase runs, in bf16 (see the module docstring). Returns
    the launch counts."""
    t0 = time.perf_counter()
    total = (0,) * 9
    x = torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen).to(dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen).to(dev)
    for (variant, engine), want in BENCH_STEPS.items():
        model = AlexNetDAU(variant=variant, engine=engine, image_size=IMAGE,
                           dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(seed))
        g = model.dau_conv2.num_dau_units_all
        with checked_kernels(f"bench {variant} {engine} bf16 step"):
            step, counts, moved = run_steps(f"bench {variant} {engine}", model, [(x, labels)],
                                            want, LR)
        total = _add(total, counts)
        print(f"train {variant} variant (G = {g} in the kernels) {engine}: one bf16 step of "
              f"{BATCH}x3x{IMAGE}x{IMAGE}, launches {COUNTS} {counts}; {len(moved)} "
              f"parameter tensors moved; {_kernel_line(lambda: step(x, labels))} [{card}]")
        del model, step
    with torch.inference_mode():
        for variant in ("small", "large"):
            kw = dict(variant=variant, image_size=IMAGE, dtype=torch.bfloat16, device=dev)
            plain = AlexNetDAU(generator=torch.Generator().manual_seed(seed), **kw)
            cached = refresh_phi_cache(AlexNetDAU(
                phi_caching=True, generator=torch.Generator().manual_seed(seed), **kw), x)
            y, y_c = plain(x).float(), cached(x).float()
            err, scale = float((y - y_c).abs().max()), float(y.abs().max())
            print(f"serve {variant} variant bf16 (auto -> fourier): phi-cached against "
                  f"uncached max|dlogits|={err:.3e} max|logits|={scale:.3e} "
                  f"bound={1e-2 * scale:.3e}")
            if y.shape != (BATCH, 1000) or not err <= 1e-2 * scale:
                raise AssertionError(f"serve {variant}: phi-cached logits disagree")
            del plain, cached
    step, carry = bench.memtest_setup(torch.bfloat16, dev)
    carry, counts = _checked_steps("bench memtest", step, carry, MEMTEST_STEPS, MEMTEST_WANT)
    total = _add(total, counts)
    print(f"memtest: {MEMTEST_STEPS} bf16 steps of 32x128x6x6 -> 256 with mu from +-10 "
          f"clipped to 3.9, all finite, launches {COUNTS} {counts}; "
          f"{_kernel_line(lambda: step(carry))} [{card}]")
    for engine, want in BENCH_LAYER.items():
        for offset in (3.0, 1.0):
            step, carry, _, _ = bench.layer_setup(32, 128, 32, 16, torch.bfloat16, engine,
                                                  offset, dev)
            carry, counts = _checked_steps(f"bench layer {engine} off{offset:g}", step, carry,
                                           2, want)
            total = _add(total, counts)
            ks = DAUConvSettings(static_max_offset=offset).synth_kernel_size
            print(f"layer cell {engine} static_max_offset {offset:g} (ks {ks}): 2 bf16 "
                  f"steps of 32x128x16x16 -> 32, launches {COUNTS} {counts}; "
                  f"{_kernel_line(lambda: step(carry))} [{card}]")
    proc = subprocess.run([sys.executable, "-m", "dau_convnet_tpu_torch.bench", "--model",
                           "layer", "--iters", "5"], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"bench --model layer --iters 5 (rc {proc.returncode}): {last}")
    if proc.returncode != 0 or json.loads(last or "{}").get("value") is None:
        raise AssertionError(f"the bench's layer cell failed: {proc.stderr[-2000:]}")
    print(f"phase 24 (the bench's configurations): launches {COUNTS} {total}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return total


# phase 25: the examples (dau_convnet_tpu_torch/examples/). Their JAX
# defaults, full width: train_alexnet_synth (small variant, N = 32 of
# 3x227x227 bf16, 8 batches, 64 classes, Adam 3e-4, 1,000 steps in chunks
# of 50) and train_cifar10 on the spatial task (f32, fourier, batch 128,
# 600 steps, evaluated at 300 and 600, --auto-tier); K1 launches per step of
# each (conv3-conv5 of AlexNet at G = 2; the CIFAR net's three layers at
# G = 4); the JAX package's recorded numbers beside which they print
ALEXNET_ARGS = ["--steps", "1000", "--chunk", "50"]
CIFAR_ARGS = ["--dataset", "spatial", "--engine", "fourier", "--steps", "600",
              "--eval-every", "300", "--auto-tier"]
EXAMPLE_K1 = {"alexnet": (0, 0, 0, 3, 0, 0, 0, 0, 0), "cifar": (0, 0, 0, 3, 0, 0, 0, 0, 0)}
JAX_ALEXNET_LOSS = (4.3812, 0.0054)  # docs/alexnet_small_1k_train.json, first/last 20
JAX_SPATIAL = (0.4975, 0.965)  # docs/TRAINING_RESULTS.md:210, top-1 and pair
JAX_CIFAR_600 = 0.46  # docs/TRAINING_RESULTS.md:158-160, TEST top-1 at step 600


def _launched(tag, fn, want_per_step, steps):
    """fn() with the counts set to 0 just before and read just after; they
    must be `want_per_step` (COUNTS) times `steps`. Returns fn's result and
    the counts."""
    _zero_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _counts()
    want = tuple(w * steps for w in want_per_step)
    if got != want:
        raise AssertionError(f"{tag}: launches {COUNTS} {got}, want {want}")
    return out, got


def examples(dev, card, spatial_logits):
    """Phase 25: the four examples on the card, in process (so the counts
    see their launches) but analyze_spatial, a child process as a user runs
    it. One step of each trainer through its module-level step builder under
    `checked_kernels`; then train_alexnet_synth and train_cifar10 at their
    full invocations, serve_inference on both engines and analyze_spatial on
    the spatial artifact (its first 500 predictions against phase 21's
    'fourier' logits, but at near-ties). Returns the launch counts."""
    t_phase = time.perf_counter()
    total = (0,) * 9
    # one checked step of each trainer, built as its example builds it
    x, y = ta.make_data(1, BATCH, 64, torch.bfloat16, dev)
    alex = AlexNetDAU(variant="small", num_classes=64, dtype=torch.bfloat16, engine="fourier",
                      device=dev, generator=torch.Generator(dev).manual_seed(0))
    step = ta.make_step(alex, torch.optim.Adam(alex.parameters(), lr=3e-4), 9)
    with checked_kernels("train_alexnet_synth step (small, bf16)"):
        loss, counts = _launched("train_alexnet_synth step", lambda: step(x[0], y[0]),
                                 EXAMPLE_K1["alexnet"], 1)
    _finite("train_alexnet_synth step", [loss])
    total = _add(total, counts)
    del alex, step, x, y
    cifar_args = tc.parse_args(CIFAR_ARGS)
    x_train, y_train, _, _ = tc.load_data(cifar_args)
    xb = torch.from_numpy(x_train[:CIFAR_BATCH]).to(dev)
    yb = torch.from_numpy(y_train[:CIFAR_BATCH]).to(dev).long()
    del x_train, y_train
    net = tc.build_model(cifar_args, tc.flax_bn_momentum(600), dev)
    step = tc.make_train_step(net, torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9),
                              "dau", 9)
    with checked_kernels("train_cifar10 step (fourier, f32)"):
        (loss, _), counts = _launched("train_cifar10 step", lambda: step(xb, yb),
                                      EXAMPLE_K1["cifar"], 1)
    _finite("train_cifar10 step", [loss])
    total = _add(total, counts)
    cifar_step = _spread(lambda: step(xb, yb), iters=3)
    del net, step, xb, yb

    with tempfile.TemporaryDirectory() as tmp:
        # train_alexnet_synth at the JAX example's defaults
        t0 = time.perf_counter()
        record, counts = _launched(
            "train_alexnet_synth", lambda: ta.main(
                ALEXNET_ARGS + ["--ckpt-dir", f"{tmp}/ck", "--out", f"{tmp}/alex.json"]),
            EXAMPLE_K1["alexnet"], 1000)
        wall = time.perf_counter() - t0
        total = _add(total, counts)
        first, last = record["loss_first20_mean"], record["loss_last20_mean"]
        print(f"example train_alexnet_synth: {record['steps']} bf16 steps, loss first-20 mean "
              f"{first}, last-20 {last} (JAX's recorded run {JAX_ALEXNET_LOSS[0]} -> "
              f"{JAX_ALEXNET_LOSS[1]}); resume delta {record['resume_logits_delta']}; max|mu| "
              f"{record['final_max_abs_mu']}; steady {record['step_ms_steady_mean']} ms a step, "
              f"spread {record['step_ms_spread_frac']}; launches {COUNTS} {counts}; "
              f"{wall:.1f} s [{card}]")
        print("example train_alexnet_synth ms a step per chunk: "
              f"{record['chunk_ms_per_step']}")
        if not (record["steps"] == 1000 and last < 0.1 * first
                and record["resume_logits_delta"] == 0.0
                and record["final_max_abs_mu"] <= 3.99):
            raise AssertionError(f"train_alexnet_synth: {record}")

        # train_cifar10 on the spatial task
        t0 = time.perf_counter()
        result, counts = _launched(
            "train_cifar10", lambda: tc.main(CIFAR_ARGS + ["--save-params", f"{tmp}/p.npz"]),
            EXAMPLE_K1["cifar"], 600)
        wall = time.perf_counter() - t0
        total = _add(total, counts)
        _, _, x_test, y_test = tc.load_data(cifar_args)
        net = az.load_model(f"{tmp}/p.npz", "dau", "fourier", dev)
        saved = az.summarize(az.predictions(net, x_test, CIFAR_BATCH, dev), y_test)
        del net
        print(f"example train_cifar10 (spatial, fourier, f32, 600 steps, --auto-tier): test "
              f"top-1 {result['test_accuracy']} (JAX's recorded run {JAX_CIFAR_600} at step "
              f"600 of 1,500), pair {saved['pair']:.4f} (its saved params: top-1 "
              f"{saved['top1']:.4f}); tiers [step, static_max_offset] {result['auto_tier']}; "
              f"all finite {result['all_finite']}; wall {result['wall_s']} s in the example, "
              f"{wall:.1f} s in all; step {_fmt(cifar_step)} over 5 runs of 3; launches "
              f"{COUNTS} {counts} [{card}]")
        if not (result["all_finite"] and result["test_accuracy"] >= 0.40
                and abs(saved["top1"] - result["test_accuracy"]) <= 5e-4):
            raise AssertionError(f"train_cifar10: {result}, saved params {saved['top1']}")

        # serve_inference: both engines, no kernel on their forward paths
        t0 = time.perf_counter()
        served, counts = _launched("serve_inference", lambda: si.main([]),
                                   (0,) * 9, 1)
        for r in served:
            print(f"example serve_inference {r['engine']}: exported program "
                  f"{r['artifact_mb']:.2f} MB, round trip max|diff| "
                  f"{r['roundtrip_max_abs_diff']:.3e} (bound 1e-5), batch-8 request "
                  f"{r['ms_per_request']:.4f} ms over 50 chained [{card}]")
        print(f"example serve_inference: {time.perf_counter() - t0:.1f} s")

        # analyze_spatial as a child process, on the repo's artifact
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dau_convnet_tpu_torch.examples.analyze_spatial",
             "--params", "docs/spatial_dau_4000_params.npz", "--engine", "fourier",
             "--predictions-out", f"{tmp}/pred.npy"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"analyze_spatial failed: {proc.stderr[-2000:]}")
        pred = torch.from_numpy(np.load(f"{tmp}/pred.npy"))[:CIFAR_TEST].to(dev)
    lines = proc.stdout.splitlines()
    top2 = spatial_logits.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 1e-3 * float(spatial_logits.abs().max())
    same = pred == spatial_logits.argmax(-1)
    print(f"example analyze_spatial (child process, fourier, f32, batches of 128): "
          f"{'; '.join(lines[:3])} (JAX's recorded {JAX_SPATIAL[0]}, {JAX_SPATIAL[1]}); first "
          f"{CIFAR_TEST} predictions: {int(same.sum())} equal phase 21's, "
          f"{int((~same & tie).sum())} differ at near-ties, {int(tie.sum())} near-ties in all; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not bool((same | tie).all()):
        raise AssertionError("analyze_spatial: predictions differ from phase 21's")
    print(f"phase 25 (the examples): launches {COUNTS} {total}, "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


# phase 26: the parallel slice (dau_convnet_tpu_torch/parallel/). The card
# is one H100 and NCCL refuses two ranks on one device, so the 2-rank meshes
# run in two processes on cuda:0 over gloo (CUDA tensors: every collective
# of the port is an all-reduce, which gloo takes), one mesh after the
# other, and the 1x1 mesh in one process over nccl.
# (backend, ranks, ((data, model) of each mesh))
PARALLEL_GROUPS = (("gloo", 2, ((2, 1), (1, 2))), ("nccl", 1, ((1, 1),)))
# launches (COUNTS) per bf16 step (fused_dx='on': K2 at conv3-conv5; conv2's
# 496 bins at G = 2 keep the unfused path, as on one device) and per f32
# step (fused_bwd='on' takes conv2 too)
PARALLEL_BF16 = (0, 0, 0, 0, 3, 0, 0, 0, 0)
PARALLEL_F32 = (0, 0, 0, 0, 4, 0, 0, 0, 0)
# the bf16 losses against the one-process step's, relative (a few bf16
# roundings of the logits); the f32 step's loss, relative; its parameters
# within two ulps plus LR * 1e-3 * max|grad| of the tensor (phase 7's
# update bound with phase 8's gradient bound carried through the update)
BF16_LOSS, F32_LOSS = 1e-2, 1e-5


def parallel(dev, seed, card):
    """Phase 26: AlexNet-DAU (default variant, G = 2) at full width, N = 32
    global, through the sharded step (`init_sharded`, `make_train_step`
    with a mesh) on the meshes of PARALLEL_MESHES, a process per rank
    (`run_ranks`; the kernels were built by phase 1, so no rank runs nvcc):
    per rank 3 bf16 SGD steps on its rows of the global batches (engine
    'auto' -> fourier, fused_dx='on'), the first under `checked_kernels`
    (every K2 launch on this shard's shapes against its twin), each step's
    launches PARALLEL_BF16, every loss finite and within BF16_LOSS of the
    one-process step's; the step's time (CUDA events, 3 runs of 2) and one
    step with every collective synchronised and timed; then one f32 step
    (fourier, fused_bwd='on', fused_dx='on'), whose loss and gathered
    parameters must match the one-process f32 step from the same weights
    (F32_LOSS; two ulps + LR * 1e-3 * max|grad|). Returns the launch counts
    of the bf16 steps, summed over ranks."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 26)
    batches = [torch.rand((BATCH, 3, IMAGE, IMAGE), generator=gen) for _ in range(STEPS)]
    labels = torch.randint(0, 1000, (BATCH,), generator=gen)
    x_dev, y_dev = [x.to(dev) for x in batches], labels.to(dev)
    model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.bfloat16,
                       fused_dx="on", device=dev, generator=torch.Generator().manual_seed(seed))
    # eager, as the sharded steps it is timed against are
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), cuda_graph=False)
    bf16 = [float(step(x, y_dev)) for x in x_dev]
    one_ms = _spread(lambda: step(x_dev[0], y_dev), repeats=3, iters=2)
    del model, step
    model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=torch.float32,
                       engine="fourier", fused_bwd="on", fused_dx="on", device=dev,
                       generator=torch.Generator().manual_seed(seed))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss32 = float(step(x_dev[0], y_dev))
    ref = dict(batches=batches, labels=labels, bf16=bf16, loss32=loss32,
               params32={k: p.detach().cpu() for k, p in model.named_parameters()},
               grad_max={k: 0.0 if p.grad is None else float(p.grad.abs().max())
                         for k, p in model.named_parameters()})
    del model, step, x_dev, y_dev
    torch.cuda.empty_cache()
    print(f"phase 26: one-process AlexNet-DAU step N={BATCH} bf16 (fused_dx='on'): losses "
          f"{[round(v, 5) for v in bf16]}, {_fmt(one_ms)} over 3 runs of 2; f32 (fourier, "
          f"fused_bwd='on', fused_dx='on') loss {loss32:.6f} [{card}]")
    total = (0,) * 9
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ref, f"{tmp}/ref.pt")
        for backend, world, meshes in PARALLEL_GROUPS:
            t0 = time.perf_counter()
            outs = run_ranks(_parallel_rank, world, meshes, seed, tmp, backend=backend,
                             timeout=300)
            for (data, model_par), *per_rank in zip(meshes, *outs):
                _print_parallel(f"{data}x{model_par} ({backend})", per_rank, bf16, one_ms,
                                loss32, card)
                for r in per_rank:
                    total = _add(total, tuple(int(c) for c in r["counts"]))
            print(f"phase 26 meshes {meshes} over {backend}: {time.perf_counter() - t0:.1f} s "
                  f"with the processes' start [{card}]")
    print(f"phase 26 (parallel): launches {COUNTS} {total} in the bf16 steps of every rank, "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


def _print_parallel(name, per_rank, bf16, one_ms, loss32, card):
    """Phase 26's lines for one mesh, a line per rank."""
    for rank, r in enumerate(per_rank):
        print(f"phase 26 mesh {name} rank {rank}: bf16 losses "
              f"{[round(v, 5) for v in r['losses']]} (one-process "
              f"{[round(v, 5) for v in bf16]}, bound {BF16_LOSS} relative), launches "
              f"{COUNTS} {PARALLEL_BF16} each step; step {_fmt(r['step_ms'])} over 3 "
              f"runs of 2 (one-process {_fmt(one_ms)}); one step with its collectives "
              f"synchronised {r['synced_ms']:.3f} ms, of which {r['coll_ms']:.3f} ms in "
              f"{r['coll_calls']} all-reduces; f32 step loss {r['loss32']:.6f} vs "
              f"{loss32:.6f} (|d| {abs(r['loss32'] - loss32):.3e}, bound "
              f"{F32_LOSS * abs(loss32):.3e}), parameters worst |d|/bound "
              f"{r['worst32']:.3e} ({r['worst32_name']}) [{card}]")


def _parallel_rank(rank, meshes, seed, tmp):
    """One rank of phase 26 (see `parallel`), in a process of its own: the
    meshes one after the other. Returns a result per mesh."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ref = torch.load(f"{tmp}/ref.pt")
    world = dist.get_world_size()
    probe = _collectives.all_reduce(torch.ones(4, device=dev), None)
    if not bool((probe == world).all()):
        raise AssertionError(f"rank {rank}: all-reduce over {world} ranks gave {probe}")
    return [_parallel_mesh(rank, make_mesh(data=data, model=model_par), seed, ref, dev,
                           f"phase 26 {data}x{model_par} rank {rank}")
            for data, model_par in meshes]


def _parallel_mesh(rank, mesh, seed, ref, dev, tag):
    """Phase 26's work on one mesh, on this rank. Its rows of each global
    batch come through `prefetch_to_device(..., sharding=batch_sharding)`."""
    bsh = batch_sharding(mesh)
    fed = list(prefetch_to_device(((x.numpy(), ref["labels"].numpy()) for x in ref["batches"]),
                                  sharding=bsh))
    xs = [x for x, _ in fed]
    labels = fed[0][1]
    if not (xs[0].is_cuda and torch.equal(xs[0].cpu(), bsh.shard(ref["batches"][0]))):
        raise AssertionError(f"{tag}: prefetch_to_device did not give this rank's rows")

    def sharded(dtype, **kw):
        model = AlexNetDAU(variant="default", image_size=IMAGE, dtype=dtype, device=dev,
                           generator=torch.Generator().manual_seed(seed), **kw)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        state, sh = init_sharded(model, opt, mesh, ref["batches"][0])
        return state, sh, make_train_step(model, opt, mesh, sh)

    state, _, step = sharded(torch.bfloat16, fused_dx="on")
    losses, total = [], (0,) * 9
    for i, x in enumerate(xs):
        _zero_counts()
        with checked_kernels(f"{tag} step 0") if i == 0 else contextlib.nullcontext():
            state, loss = step(state, x, labels)
        torch.cuda.synchronize()
        got = _counts()
        if got != PARALLEL_BF16:
            raise AssertionError(f"{tag} step {i}: launches {COUNTS} {got}, want {PARALLEL_BF16}")
        total = _add(total, got)
        losses.append(float(loss))
        want = ref["bf16"][i]
        if not (np.isfinite(losses[-1]) and abs(losses[-1] - want) <= BF16_LOSS * abs(want)):
            raise AssertionError(f"{tag} step {i}: loss {losses[-1]}, one-process {want}")
    step_ms = _spread(lambda: step(state, xs[0], labels), repeats=3, iters=2)

    # one step with each collective synchronised and timed on the host clock
    spent = [0.0, 0]
    all_reduce = _collectives.all_reduce

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(t, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    _collectives.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, xs[0], labels)
        torch.cuda.synchronize()
        synced = time.perf_counter() - t0
    finally:
        _collectives.all_reduce = all_reduce
    del state, step

    state, sh, step = sharded(torch.float32, engine="fourier", fused_bwd="on", fused_dx="on")
    _zero_counts()
    state, loss32 = step(state, xs[0], labels)
    torch.cuda.synchronize()
    if _counts() != PARALLEL_F32:
        raise AssertionError(f"{tag} f32 step: launches {COUNTS} {_counts()}, want {PARALLEL_F32}")
    loss32 = float(loss32)
    if not abs(loss32 - ref["loss32"]) <= F32_LOSS * abs(ref["loss32"]):
        raise AssertionError(f"{tag} f32 step: loss {loss32}, one-process {ref['loss32']}")
    worst, worst_name = 0.0, ""
    for k, p in gather_state(state, sh)["params"].items():
        want = ref["params32"][k].to(dev)
        top = torch.maximum(p.abs(), want.abs())
        bound = 2 * _ulp(top, torch.float32) + LR * 1e-3 * ref["grad_max"][k]
        ratio = float(((p - want).abs() / bound).max())
        if ratio > worst:
            worst, worst_name = ratio, k
    if not worst <= 1.0:
        raise AssertionError(f"{tag} f32 step: {worst_name} off by {worst:.3e} of its bound")
    return dict(losses=losses, counts=total, step_ms=step_ms, synced_ms=synced * 1e3,
                coll_ms=spent[0] * 1e3, coll_calls=spent[1], loss32=loss32, worst32=worst,
                worst32_name=worst_name)


if __name__ == "__main__":
    sys.exit(main())
