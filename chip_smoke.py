#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It serves and trains GLOW (3 scales x 8 steps, hidden 64, Haar squeeze) at
full width on 256x256x3 images, batch 8, with random weights from a seed, in
both of the port's builds: scanned (``GLOW_SCANNED``, the fused flow-step
kernels) and unrolled (``GLOW_COUPLED``, the fused coupling kernels with the
ActNorm and Conv1x1 hooks).  It trains and samples the conditional HINT
amortized posterior (``CHINT_COUPLED`` at the reference's ``seismic-uq``
widths) through the supervised loop, then the rest of the flow zoo (RealNVP,
the hyperbolic network) and the UQ layer: the ``seismic-uq`` and image-prior
scenarios trained, restored and reported, and the launchers.  Then it
serves the language models yi-6b (32 layers, d_model 4096), rwkv6-7b (32
RWKV6 layers, d_model 4096; the ``wkv_scan`` kernel) and zamba2-7b (81
Mamba2 layers and a shared attention block, d_model 3584; the ``ssd_scan``
kernel), reversible, bf16
activations, f32 weights from a seed, through ``ServeEngine.generate``, one
model at a time, and drives the flash-attention kernel through
``attn_apply(impl="flash")`` at yi-6b's width; then the rest of the dense
family and the MoE family (glm4-9b, granite-34b and command-r-plus-104b at
cut depths, granite-moe-1b-a400m whole), and trains granite-moe-1b-a400m
at full width (6 of its 24 layers) through ``train_lm`` and the
reversible scan engine, rwkv6-7b and zamba2-7b at full width and cut
depths through their plain scans; then whisper-small (the audio front end,
the encoder and cross attention) served and trained whole and
llava-next-34b (the vision front end) served at a cut depth; last, the
scanned GLOW trained, restarted and served data-parallel by two ranks that
share the card over ``gloo``, and GPipe over two stages; then the same two
ranks on a model-sharded (1, 2) mesh: the scanned GLOW trained with every
leaf stored as each rank's block, and granite-moe-1b-a400m served with
expert-parallel MoE and sequence-parallel attention.  It holds every
hand-written kernel against its plain PyTorch version.  Phases, one line
each:

1. build   - compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
             sm_90a, one process per source, all started together); each
             kernel's registers, spills and shared memory (``wkv_scan``'s
             kernels held to 128 registers a thread and no spill);
2. kernels - each kernel against its plain version at the model's shapes and
             a ragged one, in f32 and bf16, on strided views where the path
             passes them; the logdets and the sums over (b, m) are bitwise
             repeatable; ``coupling_fwd`` / ``coupling_inv`` on whole rows
             (the row stream at C = 12, 24, 48 and a ragged M: the layer's
             merged output row against the plain row version, the
             pass-through half bitwise the input's, ld against
             ``coupling_stream_ref``'s kernel-order sum, all bitwise
             repeatable) and on the half contract (the half kernels, the
             "tile" path); ``flowstep_fwd`` / ``flowstep_inv``'s path (the
             persistent stream at C = 12, 24, 48 on the halves of one
             conditioner output, at every shape and the ragged one, y, x and
             ld bitwise repeatable and ld against ``flowstep_stream_ref``'s
             kernel-order sum; the tile kernel for raw and t that are two
             tensors); ``invertible_conv1x1``'s gradient against autograd
             through the plain version; ``conv1x1_mm``'s path (the stream
             at C = 12, 24, 48, the W panels at other widths) and
             ``conv1x1_gw``'s (the cluster sum on the tensor cores at
             C = 12, 24, 48, per-chunk partials at other widths) and
             ``spine_bwd``'s (one pass summed in clusters at C = 12, 24, 48,
             the tile kernel and its reduce at other widths);
             ``coupling_bwd`` on whole rows (the backward's row stream at
             C = 12, 24, 48 and a ragged M: x, gx and gh = (graw | gt)
             against the plain row version, the pass-through halves
             bitwise, bitwise repeatable) and on strided halves (the half
             kernel, the "tile" path); the LM
             kernels' gradient guard (an input that requires grad raises on
             backward; under ``no_grad`` the same output and launches as the
             unguarded kernel);
3. serve   - ``FlowServeEngine`` on cuda, scanned then unrolled: ``log_prob``
             against the same model on the CPU, ``sample`` (the unrolled
             model through its ``kernel_inverse=True`` twin) then
             ``log_prob`` of the samples, the round trip
             ``forward(inverse(z)) == z``, and the launches of each call
             (the scanned model's 24 flow-step launches all on the stream,
             the unrolled model's 24 coupling launches all on the row
             stream);
4. train   - ``grad_mode="coupled"``, scanned then unrolled: one
             ``value_and_grad_nll`` against the same model on the CPU and
             against another backward on the card (scanned: ``stored``;
             unrolled: ``autodiff``), the launches per train step (the
             unrolled model's 24 ``coupling_fwd`` on the row stream, both
             models' 24 ``coupling_bwd`` on the backward's row stream),
             then ``train_flow`` for a few steps;
5. memory  - peak device memory of one scanned train step at 4 and 8 steps a
             scale, ``coupled`` (reversible) and ``autodiff``: the coupled
             peak must grow by less than a quarter of the autodiff peak's
             growth;
5b. chint  - ``CHINT_COUPLED`` (depth 4, hidden 128, recursion 2) at
             d_theta 32, d_y 32, a 64-wide summary net, batch 256, random
             weights from a seed: (a) one coupled train step on the card
             against the CPU (loss within 1e-4 relative, every gradient leaf
             within 1e-4 of its largest entry, the summary net's included),
             12 ``coupling_bwd`` on the half kernel ("tile") and no
             ``coupling_fwd``; (b) ``posterior_sampler`` (n = 2048) and
             ``sample`` (n = 20,000) through the ``kernel_inverse`` twin, 12
             ``coupling_inv`` a call, within 1e-4 of the plain inverse of
             the same z and cond, the same bits for the same seed, the round
             trip; (c) ``train_conditional_flow`` for 12 steps, checkpoints
             every 4, a failure at step 6 and no prefetch, bitwise equal to
             an uninterrupted run with ``prefetch=2``, the final step saved
             once; wall and device-busy ms of a train step and of the
             draws, and both kernels at this path's M = 1 shapes
             (``[chint]`` lines);
5d. examples - the port's five entry points, ``examples/torch_*.py``,
             through their ``main`` on the card, each example's own gates
             (an ``assert`` that fails the run), launches by kernel and
             seconds on one ``[examples]`` line each: quickstart (RealNVP
             on two-moons, 400 steps, the couplings on the fused kernels:
             final NLL below 1.2); train_glow at its defaults (32x32, batch
             8, 150 steps, checkpoints every 50), scanned (``invertible``)
             and unrolled (``--grad-mode coupled``, the coupling row ops):
             the loss falls, held-out bits/dim finite, samples by
             inversion; reversible_lm at revlm-100m's full width (12 x
             768, seq 512, batch 16) for ``EXAMPLE_LM_STEPS`` steps: the
             last loss below the first, then ``ServeEngine.generate``;
             amortized_inference (``lg-posterior``, 600 steps, 20,000
             draws: the posterior mean within 0.35 of the analytic one, the
             std ratio in (0.5, 2)); seismic_uq (``seismic-uq`` at
             ``EXAMPLE_SEISMIC_STEPS`` steps, 12 ``coupling_bwd`` a step: a
             finite posterior mean), whose trained run and checkpoints
             phase 5c takes over;
5c. uq      - (a) RealNVP: ``REALNVP_2D`` (the ``invertible`` engine, no
             kernel) at D = 2 and the kernel path (depth 8, hidden 128,
             ``coupled``, ``kernel_training``) at D = 32, batch 4096: a
             train step against the CPU (loss within 1e-4 relative, each
             gradient leaf within 1e-4 of its largest entry), the round
             trip, 8 ``coupling_fwd`` and 8 ``coupling_bwd`` on the half
             kernels a kernel-path step; peak memory of a step at depth 2,
             8 and 24, ``invertible`` against ``autodiff`` (the quarter
             rule of ``[memory]``); (b) ``HYPERBOLIC_DEEP`` (16 leapfrog
             layers, ``coupled``) on the pair state of 8 x 256x256x3
             images: a train step against the CPU and against
             ``autodiff`` on the card, the round trip, peak memory at
             depth 16 and 32; (c) ``seismic-uq`` as phase 5d's
             seismic_uq trained it (12 ``coupling_bwd`` a step), restored bitwise,
             ``posterior_report`` (20,000 draws in chunks of 2048, SBC and
             coverage at 128 x 64: 12 ``coupling_inv`` a sampler call, the
             streamed moments within 1e-6 of the chunks concatenated, every
             statistic finite), wall and busy ms of a train step, a chunk
             and the report; ``images-prior-scanned`` and
             ``images-prior-coupled`` trained a few steps, restored
             bitwise, 2048 samples streamed (the flow-step kernels or the
             coupling row ops, counted per step and per chunk); (d) the
             launchers as subprocesses (``--scenario lg-smoke`` trained and
             served, ``--arch yi-6b --reduced`` served), each to exit 0; the
             coupling and flow-step kernels at these paths' shapes
             (``[uq]`` lines);
6. op      - ``invertible_conv1x1`` forward and backward at the unrolled
             model's three widths, the path of ``conv1x1_mm``/``conv1x1_gw``
             (the model's ``Conv1x1`` layer computes its product with
             ``torch.matmul``, as the reference's does with XLA);
7. times   - each kernel's device time (profiler) and per-call wall time
             (CUDA events) beside its bound (its operations at the rates of
             the units they run on, named in ``rate``), its plain version's and,
             where one PyTorch call computes the same function, that call's;
             ``kernels_per_call`` where one call runs several CUDA kernels
             (``ssd_scan``'s five passes, ``conv1x1_gw``'s and
             ``spine_bwd``'s reduce, ``flowstep_fwd``'s ld reduce, one for
             ``wkv_scan`` and ``flowstep_inv``), the path of the kernels
             that have two, and each call's
             device time split by CUDA kernel (``ms_by_kernel``);
             the coupling op on whole rows at the unrolled model's (B, M,
             C) beside the half kernels on its halves, and the coupling
             backward on whole rows beside the half kernel;
             end-to-end ``log_prob``, ``sample`` and the train step of both
             models; one profiled call of each, with device time by op,
             ``aten::cat`` launches and the device's idle share (tables written to
             ``chiprun_out/chip_smoke/``);
8. LM      - ``[op]``: ``attn_apply(impl="flash")`` against ``impl="xla"`` at
             yi-6b's width (batch 8 x 2048), one ``flash_attention`` launch a
             call; ``[serve]``: yi-6b at full width and depth 2 in f32 on the
             card against the same weights on the CPU (prefill logits, 8
             greedy tokens), then at full width and depth in bf16, batch 8,
             a 2048-token prompt and 32 new tokens (``flash_attention``
             launches per ``generate``: 0, as in the reference, whose model
             never asks for the kernel); ``[times]``/``[profile]``: the
             kernel at yi-6b's prefill shape and a smaller one, prefill and
             decode-step medians, tokens/s, device idle share, peak memory;
9. SSM LMs - ``[serve]`` rwkv6-7b and then zamba2-7b, each freed before the
             next: full width at depth 2 (rwkv6) or 7 (zamba2: one
             superblock of six Mamba2 blocks with the shared attention and
             FFN, then a one-block tail) in f32 on the card against the
             same weights on the CPU (prefill logits, 8 greedy tokens); then
             full width and depth in bf16, batch 8, a 2048-token prompt, 32
             new tokens, with the scan kernels' launches per ``generate``,
             per prefill and per decode step (``wkv_scan``: 32 and 32;
             ``ssd_scan``: 81 and 0, Mamba2's decode being the plain
             recurrence, as in the reference); ``[times]``/``[profile]`` of
             prefill and the decode step.
10. dense and MoE LMs - ``[serve]`` one model at a time, each freed before
             the next: glm4-9b at full width and depth 2 in f32 against the
             CPU, then at depth 10 of 40 in bf16; granite-34b and
             command-r-plus-104b at ``REDUCED`` against the CPU, then at full
             width and a cut depth (6 and 2, named on the line; the weights
             the card-against-CPU models hold are drawn on the card and
             copied to the CPU); granite-moe-1b-a400m at full width and
             depth 2 against the CPU, then at full width and depth;
             llama4-maverick-400b-a17b at ``REDUCED`` against the CPU only
             (one superblock is about 66 GB of f32 weights).  The card-side
             runs: batch 8, a 2048-token prompt, 32 new tokens, 0
             ``flash_attention`` launches a ``generate``, tokens/s, peak
             memory, and ``[times]``/``[profile]`` of prefill and a decode
             step;
11. lm-train - granite-moe-1b-a400m through ``train_loss`` and ``train_lm``:
             (a) full width, depth 2, f32, batch 2 x 256, loss and every
             gradient leaf on the card against the CPU under ``invertible``,
             ``coupled`` and ``autodiff`` (1e-5 relative, 1e-4 of each leaf's
             largest entry), each step twice on the card bitwise, and the
             routing choices that differ; in bf16, ``invertible`` against
             ``autodiff`` rerun with the routing the ``invertible``
             backward's VJPs chose (``nn/moe.py::pinned_routes``), every
             leaf within 1e-4 of its largest entry, the flips reported and
             the unpinned gap beside it; (b) full width, depth 4 of 24
             (``LM_TRAIN_DEPTH``), bf16 activations, f32 master weights,
             AdamW, ``SyntheticTokens`` 8 x 2048, 4 steps of ``train_lm``
             under ``invertible``, profiled: per step wall, busy, idle
             share, tokens/s, peak memory; the first loss in (0, 2 log V),
             every loss finite; a restart from the step-2 checkpoint
             reproduces step 4 bitwise; (c) peak memory of a step at depth
             2 and 4 (batch 2 x 2048) in each engine: the growth
             above the step's start under ``invertible`` and ``coupled`` each
             below a quarter of ``autodiff``'s; (d) ``repro_torch.launch.train
             --arch granite-moe-1b-a400m --reduced --steps 4`` as a
             subprocess, exit 0; then rwkv6-7b (depth 1) and zamba2-7b
             (depth 7: one superblock and its one-block tail) at full width
             through their plain scans, as the reference trains through
             ``lax.scan``: (ssm-a) f32, 2 x 256, loss and every leaf against
             the CPU under ``invertible`` and ``autodiff``, bitwise on a
             repeat; (ssm-b) at one superblock (rwkv6-7b 1, zamba2-7b 6),
             bf16, 2 x 512, ``SSM_TRAIN_STEPS`` steps of ``train_lm`` (wall,
             tokens/s, peak memory), then zamba2-7b's run again, failed at
             its last step and restarted from its checkpoint, bitwise
             (``SSM_RESTART``); (ssm-c) peak memory of a step at two depths (rwkv6-7b
             1 and 2 at 2 x 1024, zamba2-7b 6 and 12 at 2 x 2048), the
             quarter rule; 0 ``wkv_scan`` / ``ssd_scan`` launches in every
             part, while phase 9's serving counts stay 32 + 32 and 81;
12. front ends - whisper-small: (frontend-a) full width, 2 encoder and 2
             decoder layers, f32, against the CPU (prefill logits, 8 greedy
             tokens, the loss and every leaf under ``invertible`` and
             ``autodiff``, bitwise on a repeat); whole in bf16, batch 8,
             1500 frames, a 64-token prompt, 32 new tokens (the encoder run
             once per ``generate``), ``[times]``/``[profile]`` of prefill
             and a decode step; (frontend-b) ``train_lm`` whole at 8 x 448
             decoder tokens with 1500 frames (wall, tokens/s, peak memory).
             llava-next-34b: full width, depth 2, f32, against the CPU
             (prefill, 8 greedy tokens); ``REDUCED`` f32, a train step
             against the CPU; full width at depth 8 (``LLAVA_WHY``) in
             bf16, batch 8, 576 patches and 1472 text tokens (2048
             positions), 32 new tokens, with ``[times]``/``[profile]``.  No
             kernel launches on these paths (reported), as in the reference;
13. dist    - two ranks share the card over ``gloo`` (NCCL refuses two
             ranks on one device), each a process started here that loads
             the kernels this process built: (a) ``GLOW_SCANNED`` at full
             width, global batch 8 (4 a rank), f32, ``coupled``:
             ``dp_value_and_grad_nll`` with the reduction overlapped into the
             backward (``psum_axis="data"``) and trailing it, loss and every
             leaf against the one-process step at batch 8 (1e-4 of each
             leaf's largest entry), overlapped against trailing, the step
             twice bitwise, 24 ``flowstep_fwd`` / ``coupling_bwd`` /
             ``spine_bwd`` a rank a step, the step wall; one update dense,
             ``topk`` (ratio 0.01) and ``int8`` with each one's wire bytes
             (host-staged bytes apart: fewer compressed, no dense gradient
             all-reduce); ``topk`` at ratio 1.0 against the dense sum; (b)
             ``train_flow(mesh=...)`` int8-compressed, 3 steps with a
             checkpoint each, killed at its last step and restarted, bitwise
             the uninterrupted run; then here the elastic restore of that
             checkpoint onto one process (the residuals re-zeroed, with the
             warning); (c) ``FlowServeEngine(mesh=...)`` ``log_prob`` and
             ``sample`` at batch 8 against the one-process engine (1e-4;
             whether bitwise is reported), 24 launches a rank a call; (d) a
             2-stage ``pipeline_forward`` and its gradient against the same
             blocks in sequence on the card (1e-5 relative), and
             ``train_pipeline`` 4 steps on the ``("pipe",)`` mesh; (e) four
             more ranks, a gloo world of their own started beside the two,
             on a (data 2, pipe 2) mesh: the same forward and gradient
             (1e-5), each stage's two data replicas bitwise equal, and
             ``train_pipeline`` 4 steps, its losses and parameters within
             1e-5 of (d)'s one-axis run and bitwise equal across the ranks,
             with each rank's wire bytes; (f) ``repro_torch.launch.train
             --scenario lg-smoke --mesh auto`` (a world of 1: a (1, 1) mesh).
             Ranks sharing one card measure correctness and wire bytes, not
             scaling.  Phases 11's depths were cut to pay for this one.
14. mesh    - two ranks share the card over ``gloo`` on a (1, 2) mesh, the
             ``model`` axis 2: (a) ``GLOW_SCANNED`` at 256x256x3, batch 8,
             f32, TF32 off, ``train_flow`` 3 steps with every parameter and
             AdamW moment stored as each rank's block (``dist/model.py``),
             twice (bitwise), loss and every trained leaf within 1e-4 of
             scale of the one-process run on the card, 24 ``flowstep_fwd`` /
             ``coupling_bwd`` / ``spine_bwd`` a rank a step, one step's wire
             bytes by collective, each rank's stored bytes beside one
             process's; ``sample`` (the inverse) on the sharded flow, 24
             ``flowstep_inv``; the elastic restore of the (1, 2) checkpoint
             onto a (2, 1) mesh, with its warning; (b) granite-moe-1b-a400m
             at full width and ``MESH_LM_DEPTH`` layers with
             ``attn_seq_shard`` served by ``ServeEngine(mesh=...)``, batch 2,
             a 512-token prompt, 16 greedy new tokens, in f32 and bf16:
             every step's logits (prefill and decode) within
             ``MESH_LOGITS_TOL`` of the step's largest while the tokens
             before it agree (bf16 decoded on the one-process engine's
             routing of every step; the unpinned first step's routing flips
             reported), f32 tokens equal to the one-process engine on the
             card (bf16's can part only inside the logits gate; where they
             part is reported), 16 experts a rank a call, prefill and
             decode-step wall and wire bytes; (c) the launchers under
             ``torch.distributed.run`` with ``--mesh 1,2``: ``train`` and
             ``serve`` at ``--arch granite-moe-1b-a400m --reduced`` and
             ``train --scenario images-prior-scanned``, beside the
             one-process references and ended before the ranks start, so
             no other process shares the card while (a) and (b) time.
  15. dryrun - the dry run (``launch/dryrun.py``) held against the card, in
             phase 14's two ranks: (a) granite-moe-1b-a400m at full width,
             ``DRY_TRAIN_DEPTH`` layers, f32, trained on a (2, 1) mesh under
             ``zero1``, ``fsdp`` and ``zero1-fsdp`` through
             ``make_train_step``, 3 steps each (zero1-fsdp twice,
             bitwise), no gradient clip, the losses
             and every leaf within 1e-5 of scale of the one-process step
             (accumulating over the ranks' row blocks), a rank's stored
             bytes beside one process's; (b) zamba2-7b at full width and
             depth 7 served on the (1, 2) mesh with ``cache_seq_fallback``,
             batch 2, a 512-token prompt, 8 new tokens, f32 (tokens equal to
             one process, each step within 5e-6 of its largest) and with
             ``servefix``'s bf16 weights (within 2e-2), one ``ssd_scan`` a
             layer a rank a prefill; each cell reckoned by ``dry_cell`` on a
             ``MeshSpec`` for the rank, its argument bytes and collectives
             equal to the rank's stored bytes (with its rows and caches) and
             counted wire; (c) ``[lm-train]`` (b)'s cell reckoned on a (1, 1)
             mesh, its measured peak over the reckoned peak in 0.8-1.25.

The flash-attention checks of phase 2 (``flash_attention`` against
``attention_ref`` at the reference's kernel-test shapes and yi-6b's, f32 and
bf16, causal or not, bitwise repeatable, bf16 with a head dim that is a
multiple of 16 on the tensor-core kernel, f32 with one that is a multiple of
8 on the TF32 kernel (3xTF32) and the rest on the CUDA-core one; bf16
strided heads; a misaligned bf16 view on the CUDA-core kernel) run with
the other kernels, and so
do the scan kernels' (``wkv_scan`` and ``ssd_scan`` against ``wkv_ref`` and
``ssd_ref`` at the reference's kernel-test shapes, f32 and bf16, and at the
models' shapes in f32 (the prefills, and rwkv6-7b's decode step), with and
without an initial state, bitwise repeatable) with their ``[times]`` at the
models' shapes (the decode step cycling through 32 layers' states, cold in
L2 as in a decode step).  A ``[seconds]``
line closes each phase.

Each path's launch counts are set to 0 just before it runs and read just
after; a kernel of the path that did not launch fails the run.  Any failure
exits non-zero.  Without a CUDA device it exits 2 and prints no result.  The
last lines are the card's name and power limit, one JSON object of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import gc
import itertools
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
SEED = 20261017
BATCH, HW = 8, 256
# the served shapes of flowstep_fwd / flowstep_inv, (B, M, C), plus a ragged M
SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (8, 300, 12)]
# coupling_fwd / coupling_inv on the unrolled model's transformed halves
# (B, M, ca), plus a ragged M; conv1x1_mm / conv1x1_gw at the model's (B, M, C),
# the widest C the reference's tests take, a ragged M, a ragged last stream
# tile at each GLOW width, and an N that leaves blocks of conv1x1_gw's one
# cluster without rows
COUPLING_SHAPES = [(8, 16384, 6), (8, 4096, 12), (8, 1024, 24), (8, 300, 6)]
CONV1X1_SHAPES = [(8, 16384, 12), (8, 4096, 24), (8, 1024, 48), (2, 128, 192), (2, 300, 8),
                  (2, 301, 12), (3, 77, 24), (1, 13, 48), (1, 200, 48)]
#: one NVIDIA H100 SXM (data sheet): HBM bytes/s, non-tensor-core f32 FLOP/s,
#: dense TF32 and bf16 tensor-core FLOP/s
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_BF16_FLOPS = 989.4e12
#: the kernels whose products run on the TF32 tensor cores (3xTF32 for f32
#: inputs, one TF32 product for bf16 ones, which TF32 holds exactly); their
#: operations are counted once, as the function needs them.  f32
#: flash_attention with a head dim that is a multiple of 8 runs there too
#: (``units``)
TF32_KERNELS = ("ssd_scan", "conv1x1_gw")
# flash_attention (B, Hq, Hkv, S, D): the reference's kernel-test shapes
# (tests/test_kernels.py:277-279), yi-6b's prefill, batch 8 x 2048, and a head
# dim that is no multiple of 16 (bf16 on the CUDA-core kernel)
ATTN_SHAPES = [(1, 4, 4, 256, 32), (2, 8, 2, 256, 64), (1, 6, 1, 512, 64), (8, 32, 4, 2048, 128),
               (2, 8, 2, 256, 36)]
# the reference's kernel tolerance (tests/test_kernels.py:43), rtol = atol
TOL_ATTN = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_ATTN_OP = 2e-4     # attn_apply flash vs einsum in f32 (tests/test_kernels.py:413-416)
TOL_LM_LOGITS = 1e-4   # yi-6b prefill logits, card vs CPU, of the largest logit
LM_BATCH, LM_PROMPT, LM_NEW = 8, 2048, 32
LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_NEW = 2, 64, 8
# wkv_scan (B, H, S, K): the reference's kernel-test shapes
# (tests/test_kernels.py:363) and rwkv6-7b's prefill, batch 8 x 2048
WKV_SHAPES = [(1, 2, 128, 16), (2, 4, 64, 32), (8, 64, 2048, 64)]
WKV_DECODE_SHAPE = (8, 64, 1, 64)  # one decode step of rwkv6-7b
WKV_DECODE_LAYERS = 32  # its layers: a decode step reads 32 distinct states
# ssd_scan (B, H, S, P, N, chunk): the reference's kernel-test shapes
# (tests/test_kernels.py:299) and zamba2-7b's prefill
SSD_SHAPES = [(1, 2, 256, 16, 16, 64), (2, 4, 128, 32, 16, 64), (8, 112, 2048, 64, 64, 256)]
# the reference's scan-kernel bound (tests/test_kernels.py:305), rtol = atol
TOL_SCAN = {"float32": 2e-4, "bfloat16": 5e-2}
# at the model shapes, f32: of the output's largest entry.  With rwkv6's
# decays (w ~ 0.9975) the wkv state sums ~400 steps and |y| reaches the
# hundreds, so an absolute bound would tighten as the sums grow
TOL_SCAN_SCALE = 1e-4
# the card-against-CPU comparison of the SSM models: rwkv6-7b at depth 2;
# zamba2-7b at depth 7, one superblock (six Mamba2 blocks, the shared
# attention and FFN) and a one-block tail
SSM_CPU_DEPTH = {"rwkv6-7b": 2, "zamba2-7b": 7}

# tolerances, with their reasons
TOL_F32 = 1e-4        # per element in f32: the reference's own kernel bound
TOL_BF16 = 2e-2       # rtol = atol on f32-upcast bf16 values (one bf16 ulp apart)
# ld sums M*ca terms in another order, relative to max(|ld|, 1) for the flow
# step and to sum |log_s| for coupling_fwd, whose random test raw makes the
# terms cancel (each term's tanh may also land one ulp from PyTorch's)
TOL_LD_REL = 1e-5
TOL_LOG_PROB = 1e-5   # relative: log_prob scales with D = 196,608
TOL_ROUND_TRIP = 1e-4  # per element in f32, as TOL_F32
# the backward's sums over (b, m) (gW, g_log_s, g_b): max |a - r| <= TOL_SUM *
# max |r| per tensor.  Each is a sum of B*M terms (up to 131,072) in another
# order than the plain version's, so an entry that cancels to near zero keeps
# the round-off of the large partial sums (7.5e-4 absolute at (8, 4096, 24)
# in f32): the bound scales with the tensor, not with each entry.
TOL_SUM = {"float32": 1e-4, "bfloat16": 5e-2}
TOL_LOSS_REL = 1e-5   # the train loss on the card against the CPU
# each gradient leaf: max |g - g_ref| <= TOL_GRAD_REL * max |g_ref|; the
# reversible backward rebuilds each step's input through up to 24 inversions
TOL_GRAD_REL = 1e-4
TRAIN_STEPS = 5


def line(phase: str, **kv):
    # one write a line: the ranks of phase 13 print to one stream at once
    sys.stdout.write(f"[{phase}] {json.dumps(kv, sort_keys=False)}\n")
    sys.stdout.flush()


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_entries(lines) -> dict[str, dict]:
    """ptxas's ``-v`` report by entry function (its mangled name): registers
    a thread and bytes of spill stores and loads."""
    import re

    entries: dict[str, dict] = {}
    name = None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entries[name] = {"registers": None, "spill_bytes": 0}
        elif name is not None and "spill" in ln:
            entries[name]["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
        elif name is not None and "registers" in ln:
            entries[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return entries


def perturb(module, seed: int, scale: float = 0.05, stacked: bool = True):
    """Add noise of std ``scale / sqrt(fan_in)`` to every float parameter of
    the flow (as ``tests/test_torch_glow*.py`` do), ``fan_in`` the product of
    the axes before the output axis, after the leading k axis of a stacked
    flow: ``init`` zeroes actnorm and each conditioner's last conv, which
    would make every coupling the identity."""
    import torch

    lead = 1 if stacked else 0
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = scale / math.sqrt(math.prod(p.shape[lead:-1]))
            p.add_(std * torch.randn(p.shape, generator=g).to(p.device))


def step_inputs(shape, dtype, dev, seed):
    """x, an_log_s, an_b, W, raw, t of one flow step; raw and t are the two
    halves of one conditioner output, as the served path passes them."""
    import torch

    b, m, c = shape
    ca = c // 2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, m, c, generator=g).to(dev, dtype)
    ls, ab = 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w = torch.randn(c, c, generator=g) / math.sqrt(c) + torch.eye(c)
    h = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    return x, ls.to(dev), ab.to(dev), w.to(dev), h[..., :ca], h[..., ca:]


def cost(name: str, shape, dtype):
    """(bytes, flops) the function needs at the flow step's (B, M, C): each
    input read once, each output written once; a C-long product at 2 flops a
    term, the elementwise work at one flop per operation (tanh and exp
    counted as one).  ``coupling_bwd`` works on the C/2 transformed
    channels; ``coupling_fwd``/``coupling_inv`` take the (B, M, ca) of the
    transformed half itself."""
    import torch

    es = torch.tensor([], dtype=dtype).element_size()
    if name == "wkv_scan":
        # (B, H, S, K): r, k, v, w in, y out in f32, u in, the (K, K) state
        # in and out.  Per (token, head) 5 K^2 + 5 K operations: since
        # r (S + u k v) = r S + (r . (u k)) v, y takes r S (2 K^2) and
        # (r . (u k)) v (5 K), and the update w S + k v^T 3 K^2
        b, h, s, kd = shape
        return es * 4 * b * h * s * kd + 4 * (b * h * s * kd + h * kd + 2 * b * h * kd * kd), \
            b * h * s * (5 * kd * kd + 5 * kd)
    if name == "ssd_scan":
        # (B, H, S, P, N, chunk): x in and y out, da and dt in (f32), B and C
        # in, the (P, N) state in and out.  Per (batch, head, chunk): C state^T
        # and the update over all c rows, G (x dt) only over the c (c + 1) / 2
        # causal pairs (t >= s) the function keeps, as flash_attention's are
        # counted; G = C B^T over those pairs once per (batch, chunk), since B
        # and C have one group, shared by the heads (PR 16 and before counted
        # it per head: 90.4 against 60.5 GFLOP at zamba2-7b's prefill)
        b, h, s, p, n, c = shape
        nbytes = 2 * es * b * h * s * p + 8 * b * h * s + 2 * es * b * s * n + 8 * b * h * p * n
        return nbytes, (b * h * (s // c) * (4 * c * n * p + p * c * (c + 1))
                        + b * (s // c) * n * c * (c + 1))
    if name == "flash_attention":
        # (B, Hq, Hkv, S, D), causal: q, k, v read and o written once; two
        # D-long products for each visible (query, key) pair, S(S+1)/2 a head
        b, hq, hkv, s, d = shape
        return es * 2 * d * s * (b * hq + b * hkv), 4 * b * hq * d * (s * (s + 1) // 2)
    b, m, c = shape
    ca = c // 2
    if name == "spine_bwd":
        # x2, gx2 in; x, gx out; W, W^-1, an_log_s, an_b in; gW, g_ls, g_b out
        nbytes = 4 * es * b * m * c + 4 * (2 * c * c + 2 * c) + 4 * (c * c + 2 * c)
        # x1, gx1 and gW: three C-long products an element; x, gx, g_ls, g_b: 6
        return nbytes, b * m * c * (6 * c + 6)
    if name == "coupling_bwd":
        # y, raw, t, gy in; x, gx, graw, gt out; gld in
        return 8 * es * b * m * ca + 4 * b, 15 * b * m * ca
    if name == "coupling_bwd_half":
        # the half contract (B, M, ca) = shape, as a HINT cross node calls it:
        # y, raw, t, gy in; x, gx, graw, gt out; gld in
        return 8 * es * b * m * c + 4 * b, 15 * b * m * c
    if name == "coupling_bwd_rows":
        # the backward on whole rows (B, M, C) = shape: y, h (raw | t), gy in,
        # x, gx, gh (graw | gt) out, gld in; the same work on the ca coupled
        # columns, the pass-through halves moved as they are
        return 6 * es * b * m * c + 4 * b, 15 * b * m * ca
    if name in ("coupling_fwd", "coupling_inv"):
        # on the transformed half (B, M, ca) = shape: x|y, raw, t in, y|x out
        # (the forward's ld out); tanh, divide, scale, exp, multiply, add (+
        # the ld sum)
        fwd = name == "coupling_fwd"
        return 4 * es * b * m * c + (4 * b if fwd else 0), (7 if fwd else 6) * b * m * c
    if name in ("coupling_fwd_rows", "coupling_inv_rows"):
        # the layer's op on whole rows (B, M, C) = shape: x|y and h (raw | t)
        # in, the merged y|x out (ld out); the same work on the ca coupled
        # columns, the pass-through half moved as it is
        fwd = name == "coupling_fwd_rows"
        return 3 * es * b * m * c + (4 * b if fwd else 0), (7 if fwd else 6) * b * m * ca
    if name == "conv1x1_mm":
        return es * (2 * b * m * c + c * c), 2 * b * m * c * c  # x, W in; y out
    if name == "conv1x1_gw":
        return 2 * es * b * m * c + 4 * c * c, 2 * b * m * c * c  # x, gy in; gW out
    big = es * (b * m * c + 2 * b * m * ca + b * m * c)  # x|y, raw, t, y|x
    small = 4 * (c * c + 2 * c)                           # W, an_log_s, an_b
    if name == "flowstep_fwd":
        return big + small + 4 * b, b * m * c * (2 * c + 2) + b * m * ca * 7
    return big + small, b * m * c * (2 * c + 2) + b * m * ca * 6


def rate(name, dtype) -> tuple[float, str]:
    """The card's rate for the units the kernel's products run on, and its
    name: bf16 tensor cores for flash attention's bf16 inputs, TF32 tensor
    cores for ``TF32_KERNELS``, the CUDA cores' f32 rate otherwise (the flow
    kernels compute in f32 whatever their storage type)."""
    import torch

    if name == "flash_attention" and dtype == torch.bfloat16:
        return H100_BF16_FLOPS, "bf16 tensor cores"
    if name in TF32_KERNELS:
        return H100_TF32_FLOPS, "tf32 tensor cores"
    return H100_F32_FLOPS, "f32 cuda cores"


def units(name, shape, dtype) -> list[tuple[float, float, str]]:
    """The kernel's operations by the units they run on: (operations, the
    units' rate, their name).  ``spine_bwd`` at the cluster kernel's widths
    (C = 12, 24, 48) runs gW = x1^T gx2 (2 C operations an element) on the
    TF32 tensor cores and the rest (x1, gx1, the elementwise work: 4 C + 6)
    on the CUDA cores; the tile kernel at other widths runs all of it on the
    CUDA cores.  Every other kernel runs on the units ``rate`` names."""
    import torch

    _, flops = cost(name, shape, dtype)
    if name == "flash_attention" and dtype == torch.float32 and shape[-1] % 8 == 0:
        # the TF32 kernel: the two products on the TF32 tensor cores, their
        # operations counted once (three TF32 products each in 3xTF32)
        return [(flops, H100_TF32_FLOPS, "tf32 tensor cores")]
    if name == "spine_bwd" and shape[-1] in (12, 24, 48):
        b, m, c = shape
        gw = 2 * b * m * c * c
        return [(flops - gw, H100_F32_FLOPS, "f32 cuda cores"),
                (gw, H100_TF32_FLOPS, "tf32 tensor cores")]
    peak, unit = rate(name, dtype)
    return [(flops, peak, unit)]


def ops_ms(name, shape, dtype) -> float:
    """The least time of the kernel's operations: each kind at its units'
    rate, the kinds one after another."""
    return 1e3 * sum(n / peak for n, peak, _ in units(name, shape, dtype))


def bound_ms(name, shape, dtype) -> float:
    nbytes, _ = cost(name, shape, dtype)
    return max(1e3 * nbytes / H100_BYTES_PER_S, ops_ms(name, shape, dtype))


def bound_by(name, shape, dtype) -> str:
    nbytes, _ = cost(name, shape, dtype)
    return "bytes" if 1e3 * nbytes / H100_BYTES_PER_S >= ops_ms(name, shape, dtype) \
        else "operations"


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Wall time of one call, launches back to back between CUDA events: the
    caller's view, which includes the host work of each call (20 calls; 50
    until the examples needed the time)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _is_device_event(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _kernel_name(key: str) -> str:
    """A profiler kernel name without its template arguments, parameters and
    namespace; PyTorch's own kernels as "torch <what>"."""
    if "at::native" in key:
        return "torch copy" if "copy" in key else "torch op"
    return key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0].split(
        "<")[0]


def device_ms(fn, reps: int = 20, attempts: int = 10) -> tuple[float, str, dict | None]:
    """Device time of one call, where it came from, and its split by the
    CUDA kernels the call launches (ms each, by ``_kernel_name``).

    First choice, ``"profiler"``: the summed durations of every kernel the
    call launches (host work and gaps between launches are not counted).
    The profiler now and then returns a window with no device events, or
    with fewer kernels than the ``reps`` calls launched (one such window
    read 0.095 µs for a 19 µs kernel).  Such a window is taken again, up to
    ``attempts`` times.  Late in a long run the profiler can lose some
    kernels of every window of a call that launches one kernel; then the
    time is ``queued_ms``'s, ``"queued_events"``, which also counts the
    device's gaps between kernels (about 1 µs a launch), and the split is
    that time under the one kernel's name (None if the windows named
    several)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: set[str] = set()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if _is_device_event(e)]
        names |= {_kernel_name(e.key) for e in kernels}
        total_us = sum(e.device_time_total for e in kernels)
        if total_us > 0 and sum(e.count for e in kernels) >= reps:
            split: dict[str, float] = {}
            for e in kernels:
                name = _kernel_name(e.key)
                split[name] = split.get(name, 0.0) + e.device_time_total / reps / 1e3
            return total_us / reps / 1e3, "profiler", split
    ms = queued_ms(fn, reps)
    return ms, "queued_events", ({names.pop(): ms} if len(names) == 1 else None)


def queued_ms(fn, reps: int = 20, spin_cycles: int = 20_000_000) -> float:
    """Device time of one call without the profiler: ``reps`` calls queued
    behind a spin kernel that keeps the card busy while the host enqueues
    them, so they run back to back and CUDA events around them time the
    device (the gaps between kernels included, the host's work not).  The
    spin is doubled and the window retaken while the host took longer to
    enqueue the calls than the spin lasted."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(8):
        ev[0].record()
        torch.cuda._sleep(spin_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        spin_cycles *= 2
    raise SystemExit("chip_smoke: FAILED: the host could not queue the calls ahead of the card")


def e2e_wall_ms(fn, reps=15):
    """Median wall ms of ``fn`` (each call synchronised), and every run."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return sorted(out)[len(out) // 2], out


def profile_call(fn, median_ms, name) -> tuple[float, float, list]:
    """One profiled call of ``fn``: its device-busy ms (every kernel's
    time), the idle share against the unprofiled median, and the profiler's
    events; the table goes to ``chiprun_out/chip_smoke/profile_<name>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    (OUT / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60, max_name_column_width=100))
    busy_ms = sum(e.device_time_total for e in events if _is_device_event(e)) / 1e3
    return busy_ms, max(0.0, 1 - busy_ms / median_ms), events


def time_kernel(name, shape, dtype, k_fn, p_fn, lib_fn=None, plain_reps=None, **extra) -> dict:
    """One ``[times]`` line: the kernel's, its plain version's and (where one
    PyTorch call computes the same function) that call's device time, beside
    the bound, at ``shape``; ``ms_from`` names each time's source.
    ``plain_reps`` times a slow plain version (a Python loop over time) over
    fewer calls; ``ms_by_kernel`` splits the kernel call's device time by
    CUDA kernel; ``extra`` (the kernel's path) goes into the line as is."""
    ms, k_src, k_split = device_ms(k_fn)
    plain_ms, p_src, _ = (device_ms(p_fn) if plain_reps is None
                          else device_ms(p_fn, reps=plain_reps))
    lib_ms, l_src, _ = device_ms(lib_fn) if lib_fn is not None else (None, None, None)
    nbytes, flops = cost(name, shape, dtype)
    row = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(name, shape, dtype),
           "rate": " + ".join(unit for _, _, unit in units(name, shape, dtype)),
           "library_ms": lib_ms, "ms_from": {"ms": k_src, "plain_ms": p_src, "library_ms": l_src},
           "call_ms": call_ms(k_fn),
           "plain_call_ms": call_ms(p_fn) if plain_reps is None else call_ms(p_fn, plain_reps, 1),
           "bytes": nbytes, "flops": flops, "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
           "ms_by_kernel": k_split, **extra}
    line("times", kernel=name, **row)
    return row


def check_bwd_kernels(dev) -> dict:
    """Phase 2, the backward kernels: ``spine_bwd`` and ``coupling_bwd``
    against their plain versions at the trained shapes and a ragged one, in
    f32 and bf16; ``coupling_bwd`` on whole rows (the backward's row stream:
    x, gx and gh from y, h and gy, as both models' backward passes them) and
    on strided halves (the half kernel); the sums over (b, m) and the row
    stream's outputs bitwise repeatable.  Returns each kernel's largest
    per-element f32 error."""
    import torch
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.coupling.ref import coupling_bwd_ref, coupling_bwd_rows_ref
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ops import conditioner_output
    from repro_torch.kernels.flowstep.ref import spine_bwd_ref

    max_err = {"spine_bwd": 0.0, "coupling_bwd": 0.0}
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x2, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED + 5)
            g = torch.Generator().manual_seed(SEED + 6)
            gx2 = torch.randn(shape, generator=g).to(dev, dtype)
            gld = torch.randn(shape[0], generator=g).to(dev)
            w_inv = torch.linalg.inv(w)
            ca = shape[-1] // 2
            before = dict(kern.spine_bwd.launches_by_path)
            got = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
            again = kern.spine_bwd(x2, gx2, w, w_inv, ls, ab)
            ref = spine_bwd_ref(x2, gx2, w, w_inv, ls, ab)
            path = kern.spine_path(x2, gx2)
            check(path == "cluster" and kern.spine_bwd.launches_by_path[path] == before[path] + 2,
                  f"spine_bwd at {shape} {dname} did not take the cluster kernel")
            before_c = dict(ckern.coupling_bwd.launches_by_path)
            c_got = ckern.coupling_bwd(x2[..., :ca], raw, t, gx2[..., :ca], gld)
            c_ref = coupling_bwd_ref(x2[..., :ca], raw, t, gx2[..., :ca], gld)
            # the backward's whole rows: y = x2, h whose halves raw and t are
            h = conditioner_output(raw, t)
            check(h.data_ptr() == raw.data_ptr() and ckern.coupling_path(x2, raw, t, gy=gx2)
                  == "rows", f"coupling_bwd rows at {shape} {dname} would take the tile path")
            r_got = ckern.coupling_bwd.rows(x2, h, gx2, gld)
            r_again = ckern.coupling_bwd.rows(x2, h, gx2, gld)
            r_ref = coupling_bwd_rows_ref(x2, h, gx2, gld)
            torch.cuda.synchronize()
            check(ckern.coupling_bwd.launches_by_path == {"rows": before_c["rows"] + 2,
                                                          "tile": before_c["tile"] + 1},
                  f"coupling_bwd at {shape} {dname} did not take the row stream and the half")
            check(all(torch.equal(a, b) for a, b in zip(r_got, r_again)),
                  f"coupling_bwd rows not bitwise repeatable at {shape} {dname}")
            check(torch.equal(r_got[0][..., ca:], x2[..., ca:])
                  and torch.equal(r_got[1][..., ca:], gx2[..., ca:])
                  and torch.equal(r_got[2][..., ca:], gx2[..., :ca]),
                  f"coupling_bwd rows at {shape} {dname}: a pass-through half or gt changed")
            errs = {}
            for name, pairs in (("spine_bwd", zip(got[:2], ref[:2])),
                                ("coupling_bwd", zip(c_got, c_ref)),
                                ("coupling_bwd_rows", zip(r_got, r_ref))):
                for a, r in pairs:
                    d = (a.float() - r.float()).abs()
                    errs[name] = max(errs.get(name, 0.0), d.max().item())
                    if dtype == torch.float32:
                        check(d.max().item() <= TOL_F32, f"{name} f32 {shape}: {d.max().item()}")
                    else:
                        bad = d > TOL_BF16 + TOL_BF16 * r.float().abs()
                        check(not bad.any().item(), f"{name} bf16 {shape}")
            tol = TOL_SUM[dname]
            sum_err = 0.0
            for what, a, r, b in zip(("gW", "g_log_s", "g_b"), got[2:], ref[2:], again[2:]):
                check(torch.equal(a, b), f"spine_bwd {what} not bitwise repeatable at {shape} {dname}")
                rel = (a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                sum_err = max(sum_err, rel)
                check(rel <= tol, f"spine_bwd {what} {shape} {dname}: {rel} of its scale")
            if dtype == torch.float32:
                for name in max_err:
                    max_err[name] = max(max_err[name], errs[name])
            if dtype == torch.float32:
                max_err["coupling_bwd"] = max(max_err["coupling_bwd"], errs["coupling_bwd_rows"])
            line("kernels", shape=list(shape), dtype=dname, spine_bwd_path=path,
                 spine_bwd_max_abs_err=errs["spine_bwd"],
                 spine_bwd_sums_max_rel_err=sum_err, coupling_bwd_max_abs_err=errs["coupling_bwd"],
                 coupling_bwd_rows_max_abs_err=errs["coupling_bwd_rows"],
                 coupling_bwd_rows_bitwise_repeatable=True, sums_bitwise_repeatable=True)
    return max_err


def max_rel_leaf_err(grads, ref) -> tuple[float, str]:
    """max over leaves of max|g - g_ref| / max|g_ref|, and the worst leaf."""
    worst, where = 0.0, ""
    for name, r in ref.items():
        r = r.float().cpu()
        err = (grads[name].float().cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        if err > worst:
            worst, where = err, name
    return worst, where


def train_phase(dev, card) -> dict:
    """Phase 4: ``GLOW_SCANNED`` training at 256x256x3, batch 8, on the card.
    Returns the launches of one train step, the model and its batch."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.train.loop import train_flow

    def make(device, coupled_bwd="auto"):
        flow = build_flow(GLOW_SCANNED, coupled_bwd=coupled_bwd, channels=3,
                          generator=torch.Generator().manual_seed(SEED), device=device)
        perturb(flow, SEED + 1)
        return flow

    data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED)
    x_cpu = data.batch_at(0)
    x = x_cpu.to(dev)
    flow = make(dev)
    stacks = [layer.layer for layer in flow.layers if hasattr(layer, "layer")
              and hasattr(layer.layer, "coupled_bwd")]
    check(flow.engine == "coupled" and len(stacks) == 3
          and all(s.coupled_bwd == "reversible" for s in stacks),
          "coupled_bwd='auto' did not resolve to 'reversible' on cuda")

    kernels = (*kern.KERNELS, *ckern.KERNELS)
    reset(kernels)
    loss, grads = value_and_grad_nll(flow, x)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(launches == {"flowstep_fwd": 24, "flowstep_inv": 0, "spine_bwd": 24, "coupling_fwd": 0,
                       "coupling_inv": 0, "coupling_bwd": 24}, f"train-step launches: {launches}")
    spine_by_path = dict(kern.spine_bwd.launches_by_path)
    check(spine_by_path == {"cluster": 24, "tile": 0}, f"spine_bwd paths: {spine_by_path}")
    fwd_by_path = dict(kern.flowstep_fwd.launches_by_path)
    check(fwd_by_path == {"stream": 24, "tile": 0}, f"flowstep_fwd paths: {fwd_by_path}")
    bwd_by_path = dict(ckern.coupling_bwd.launches_by_path)
    check(bwd_by_path == {"rows": 24, "tile": 0}, f"coupling_bwd paths: {bwd_by_path}")

    t0 = time.perf_counter()
    flow_cpu = make("cpu")
    check(flow_cpu.engine == "autodiff", "coupled_bwd='auto' did not resolve to 'stored' on the CPU")
    loss_cpu, grads_cpu = value_and_grad_nll(flow_cpu, x_cpu)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    grad_rel, grad_worst = max_rel_leaf_err(grads, grads_cpu)
    check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL, f"train loss vs cpu: {loss_rel}")
    check(all(torch.isfinite(g).all().item() for g in grads.values()), "gradients not finite")
    check(grad_rel <= TOL_GRAD_REL, f"gradient vs cpu: {grad_rel} at {grad_worst}")
    del flow_cpu, grads_cpu

    flow_st = make(dev, "stored")
    loss_st, grads_st = value_and_grad_nll(flow_st, x)
    st_rel, st_worst = max_rel_leaf_err(grads, grads_st)
    st_loss_rel = abs(loss.item() - loss_st.item()) / abs(loss_st.item())
    check(st_loss_rel <= TOL_LOSS_REL and st_rel <= TOL_GRAD_REL,
          f"reversible vs stored on the card: loss {st_loss_rel}, grad {st_rel} at {st_worst}")
    del flow_st, grads_st

    res = train_flow(make(dev), data, TrainConfig(steps=TRAIN_STEPS), device=dev)
    first_rel = abs(res.losses[0] - loss.item()) / abs(loss.item())
    check(len(res.losses) == TRAIN_STEPS and all(math.isfinite(v) for v in res.losses),
          f"train_flow losses: {res.losses}")
    check(first_rel <= 1e-6, f"train_flow step 0 loss {res.losses[0]} vs {loss.item()}")
    line("train", image=[BATCH, HW, HW, 3], loss=loss.item(), loss_rel_err_vs_cpu=loss_rel,
         grad_max_rel_err_vs_cpu=grad_rel, grad_worst_leaf_vs_cpu=grad_worst,
         cpu_reference_s=cpu_s, loss_rel_err_vs_stored=st_loss_rel,
         grad_max_rel_err_vs_stored=st_rel, launches_per_train_step=launches,
         spine_bwd_launches_by_path=spine_by_path, flowstep_fwd_launches_by_path=fwd_by_path,
         coupling_bwd_launches_by_path=bwd_by_path,
         train_flow_losses=res.losses, step0_loss_bitwise_equal=res.losses[0] == loss.item(),
         n_params=sum(p.numel() for p in flow.parameters()), card=card)
    return {"launches": launches, "flow": flow, "x": x, "coupling_bwd_by_path": bwd_by_path}


def memory_phase(dev, card) -> dict:
    """Phase 5: peak device memory of one train step (value and gradient,
    then the AdamW update) at 4 and 8 steps a scale."""
    import torch
    from repro_torch.core import build_glow_scanned
    from repro_torch.data.synthetic import SyntheticImages

    x = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED).batch_at(0).to(dev)
    peaks = {}
    for mode in ("coupled", "autodiff"):
        for k in (4, 8):
            flow = build_glow_scanned(n_scales=3, k_steps=k, hidden=64, grad_mode=mode,
                                      coupled_bwd="reversible", channels=3,
                                      generator=torch.Generator().manual_seed(SEED), device=dev)
            perturb(flow, SEED + 1)
            peak, start = peak_step_bytes(flow, x)
            peaks[f"{mode}_k{k}"] = {"peak_bytes": peak, "above_start_bytes": peak - start}
            del flow
    growth = {m: peaks[f"{m}_k8"]["peak_bytes"] - peaks[f"{m}_k4"]["peak_bytes"]
              for m in ("coupled", "autodiff")}
    line("memory", image=[BATCH, HW, HW, 3], peaks=peaks, growth_k4_to_k8_bytes=growth, card=card)
    check(growth["coupled"] < 0.25 * growth["autodiff"],
          f"coupled peak grew {growth['coupled']} B from k=4 to 8, autodiff {growth['autodiff']} B")
    return peaks


def coupling_inputs(shape, dtype, dev, seed):
    """x, raw, t of one unrolled coupling at its transformed half's (B, M,
    ca): x the first ca channels of a (B, M, 2*ca) tensor, raw and t the two
    halves of one conditioner output, as the path passes them."""
    import torch

    b, m, ca = shape
    g = torch.Generator().manual_seed(seed)
    xx = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    h = torch.randn(b, m, 2 * ca, generator=g).to(dev, dtype)
    return xx[..., :ca], h[..., :ca], h[..., ca:]


def row_inputs(shape, dtype, dev, seed):
    """x and the conditioner output h (raw | t) of one unrolled coupling
    layer as whole (B, M, C) rows, as the layer passes them to the row op."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dev, dtype) for _ in range(2))


def conv1x1_inputs(shape, dtype, dev, seed):
    """x, gy (B, M, C) in ``dtype`` and an f32 W (C, C) of unit scale."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    gy = torch.randn(shape, generator=g).to(dev, dtype)
    w = torch.randn(shape[-1], shape[-1], generator=g) / math.sqrt(shape[-1])
    return x, gy, w.to(dev)


def _elem_check(name, a, r, dtype, shape) -> float:
    import torch

    d = (a.float() - r.float()).abs()
    if dtype == torch.float32:
        check(d.max().item() <= TOL_F32, f"{name} f32 {shape}: {d.max().item()}")
    else:
        bad = d > TOL_BF16 + TOL_BF16 * r.float().abs()
        check(not bad.any().item(), f"{name} bf16 {shape}")
    return d.max().item()


def check_unrolled_kernels(dev) -> dict:
    """Phase 2, the unrolled model's kernels: ``coupling_fwd`` /
    ``coupling_inv`` and ``conv1x1_mm`` / ``conv1x1_gw`` against their plain
    versions, f32 and bf16; ``ld`` and ``gW`` bitwise repeatable; then
    ``invertible_conv1x1``'s gradient through autograd against the plain
    version's.  Returns each kernel's largest per-element f32 error."""
    import torch
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.conv1x1.ops import invertible_conv1x1
    from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref, conv1x1_mm_ref
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling.ref import (coupling_fwd_ref, coupling_fwd_rows_ref,
                                                  coupling_inv_ref, coupling_inv_rows_ref,
                                                  coupling_stream_ref)

    max_err = dict.fromkeys(("coupling_fwd", "coupling_inv", "conv1x1_mm", "conv1x1_gw"), 0.0)
    # the row stream: the layer's whole (B, M, C) row from x and h
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x, h = row_inputs(shape, dtype, dev, SEED + 9)
            ca = shape[-1] // 2
            raw = h[..., :ca]
            check(ck.coupling_path(x, raw, h[..., ca:]) == "rows",
                  f"coupling rows at {shape} {dname} would take the tile path")
            before = (dict(ck.coupling_fwd.launches_by_path),
                      dict(ck.coupling_inv.launches_by_path))
            y, ld = ck.coupling_fwd.rows(x, h)
            y_again, ld_again = ck.coupling_fwd.rows(x, h)
            y_r, ld_r = coupling_fwd_rows_ref(x, h)
            _, ld_k = coupling_stream_ref(x, h)
            back = ck.coupling_inv.rows(y_r, h)
            back_again = ck.coupling_inv.rows(y_r, h)
            back_r = coupling_inv_rows_ref(y_r, h)
            torch.cuda.synchronize()
            check(ck.coupling_fwd.launches_by_path == {**before[0], "rows": before[0]["rows"] + 2}
                  and ck.coupling_inv.launches_by_path == {**before[1],
                                                           "rows": before[1]["rows"] + 2},
                  f"coupling rows at {shape} {dname} did not take the row stream")
            errs = {"coupling_fwd": _elem_check("coupling_fwd rows", y, y_r, dtype, shape),
                    "coupling_inv": _elem_check("coupling_inv rows", back, back_r, dtype, shape)}
            check(torch.equal(y[..., ca:], x[..., ca:]) and torch.equal(back[..., ca:],
                                                                        y_r[..., ca:]),
                  f"coupling rows at {shape} {dname}: the pass-through half changed")
            ld_scale = (2.0 * torch.tanh(raw.float() / 2.0)).abs().sum(dim=(1, 2)).clamp_min(1.0)
            err_ld = ((ld - ld_r).abs() / ld_scale).max().item()
            err_ld_k = ((ld - ld_k).abs() / ld_scale).max().item()
            check(err_ld <= TOL_LD_REL and err_ld_k <= TOL_LD_REL,
                  f"coupling rows ld {shape} {dname}: {err_ld} (plain), {err_ld_k} (kernel order)")
            check(torch.equal(ld, ld_again) and torch.equal(y, y_again)
                  and torch.equal(back, back_again),
                  f"coupling rows y, ld or x not bitwise repeatable at {shape} {dname}")
            if dtype == torch.float32:
                for name, e in errs.items():
                    max_err[name] = max(max_err[name], e)
            line("kernels", shape=list(shape), dtype=dname, coupling_path="rows",
                 coupling_fwd_max_abs_err=errs["coupling_fwd"],
                 coupling_inv_max_abs_err=errs["coupling_inv"], pass_through_bitwise=True,
                 ld_max_rel_err=err_ld, ld_max_rel_err_vs_kernel_order=err_ld_k,
                 ld_bitwise_equal_to_kernel_order=bool(torch.equal(ld, ld_k)),
                 bitwise_repeatable=True)
    # the half kernels (the tile path) on their (B, M, ca) contract
    for shape in COUPLING_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x, raw, t = coupling_inputs(shape, dtype, dev, SEED + 9)
            before = (dict(ck.coupling_fwd.launches_by_path),
                      dict(ck.coupling_inv.launches_by_path))
            y, ld = ck.coupling_fwd(x, raw, t)
            _, ld_again = ck.coupling_fwd(x, raw, t)
            back = ck.coupling_inv(x, raw, t)
            y_r, ld_r = coupling_fwd_ref(x, raw, t)
            torch.cuda.synchronize()
            check(ck.coupling_fwd.launches_by_path == {**before[0], "tile": before[0]["tile"] + 2}
                  and ck.coupling_inv.launches_by_path == {**before[1],
                                                           "tile": before[1]["tile"] + 1},
                  f"coupling halves at {shape} {dname} did not take the half kernels")
            errs = {"coupling_fwd": _elem_check("coupling_fwd", y, y_r, dtype, shape),
                    "coupling_inv": _elem_check("coupling_inv", back,
                                                coupling_inv_ref(x, raw, t), dtype, shape)}
            # a sum of M*ca terms that cancel for random raw: its round-off
            # (and each term's tanh, one ulp apart) scales with sum |log_s|
            ld_scale = (2.0 * torch.tanh(raw.float() / 2.0)).abs().sum(dim=(1, 2))
            err_ld = ((ld - ld_r).abs() / ld_scale.clamp_min(1.0)).max().item()
            check(err_ld <= TOL_LD_REL, f"coupling_fwd ld {shape} {dname}: {err_ld}")
            check(torch.equal(ld, ld_again), f"coupling_fwd ld not bitwise repeatable at {shape}")
            if dtype == torch.float32:
                for name, e in errs.items():
                    max_err[name] = max(max_err[name], e)
            line("kernels", shape=list(shape), dtype=dname, coupling_path="tile",
                 coupling_fwd_max_abs_err=errs["coupling_fwd"],
                 coupling_inv_max_abs_err=errs["coupling_inv"], ld_max_rel_err=err_ld,
                 ld_bitwise_repeatable=True)
    for shape in CONV1X1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x, gy, w = conv1x1_inputs(shape, dtype, dev, SEED + 10)
            before = dict(c1k.conv1x1_mm.launches_by_path)
            y = c1k.conv1x1_mm(x, w)
            gx = c1k.conv1x1_mm(gy, w.T)
            ran = [p for p, n in c1k.conv1x1_mm.launches_by_path.items() if n != before[p]]
            check(ran == [c1k.mm_path(x)], f"conv1x1_mm {shape} {dtype} ran {ran}")
            before_gw = dict(c1k.conv1x1_gw.launches_by_path)
            gw, gw_again = c1k.conv1x1_gw(x, gy), c1k.conv1x1_gw(x, gy)
            ran_gw = [p for p, n in c1k.conv1x1_gw.launches_by_path.items() if n != before_gw[p]]
            check(ran_gw == [c1k.gw_path(x, gy)], f"conv1x1_gw {shape} {dtype} ran {ran_gw}")
            gw_r = conv1x1_gw_ref(x, gy)
            torch.cuda.synchronize()
            err_mm = max(_elem_check("conv1x1_mm", y, conv1x1_mm_ref(x, w), dtype, shape),
                         _elem_check("conv1x1_mm (W^T)", gx, conv1x1_mm_ref(gy, w.T), dtype, shape))
            err_gw = (gw - gw_r).abs().max().item()
            rel = err_gw / max(gw_r.abs().max().item(), 1e-30)
            check(rel <= TOL_SUM[dname], f"conv1x1_gw {shape} {dname}: {rel} of its scale")
            check(torch.equal(gw, gw_again), f"conv1x1_gw not bitwise repeatable at {shape} {dname}")
            if dtype == torch.float32:
                max_err["conv1x1_mm"] = max(max_err["conv1x1_mm"], err_mm)
                max_err["conv1x1_gw"] = max(max_err["conv1x1_gw"], err_gw)
            line("kernels", shape=list(shape), dtype=dname, conv1x1_mm_path=ran[0],
                 conv1x1_mm_max_abs_err=err_mm, conv1x1_gw_path=ran_gw[0],
                 conv1x1_gw_max_rel_err=rel, gw_bitwise_repeatable=True)
    # the op's gradient: conv1x1_mm (W^T) and conv1x1_gw inside autograd
    for shape in CONV1X1_SHAPES[:3]:
        x, gy, w = conv1x1_inputs(shape, torch.float32, dev, SEED + 11)

        def grads(fn):
            x_, w_ = x.clone().requires_grad_(), w.clone().requires_grad_()
            return torch.autograd.grad((fn(x_, w_) * gy).sum(), (x_, w_))

        (gx, gw), (gx_r, gw_r) = grads(invertible_conv1x1), grads(conv1x1_mm_ref)
        torch.cuda.synchronize()
        err_gx = (gx - gx_r).abs().max().item()
        rel_gw = (gw - gw_r).abs().max().item() / gw_r.abs().max().item()
        check(err_gx <= TOL_F32 and rel_gw <= TOL_SUM["float32"],
              f"invertible_conv1x1 gradient {shape}: gx {err_gx}, gW {rel_gw}")
        line("kernels", op="invertible_conv1x1", shape=list(shape), dtype="float32",
             gx_max_abs_err=err_gx, gw_max_rel_err=rel_gw)
    return max_err


def build_coupled(device, kernel_inverse=False, grad_mode=None):
    """``GLOW_COUPLED`` from the seed, perturbed so every coupling is live;
    the same parameters whatever ``kernel_inverse`` and ``grad_mode``."""
    import torch
    from repro_torch.configs.flows import GLOW_COUPLED
    from repro_torch.core import build_glow

    cfg = GLOW_COUPLED
    flow = build_glow(n_scales=cfg.n_scales, k_steps=cfg.k_steps, hidden=cfg.hidden,
                      grad_mode=grad_mode or cfg.grad_mode, kernel_inverse=kernel_inverse,
                      channels=3,
                      generator=torch.Generator().manual_seed(SEED), device=device)
    perturb(flow, SEED + 1, stacked=False)
    return flow


def reset(kernels):
    """Set every launch count to 0, by path too where a kernel has two."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "launches_by_path"):
            k.launches_by_path = dict.fromkeys(k.launches_by_path, 0)


def coupled_serve_phase(dev, card, x_cpu) -> dict:
    """Phase 3, unrolled: ``GLOW_COUPLED`` served on the card, ``sample``
    through the ``kernel_inverse=True`` twin that shares its parameters."""
    import torch
    from repro_torch.core import derive_key, share_parameters, std_normal_sample
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.serve.engine import FlowServeEngine

    kernels = (*fk.KERNELS, *ck.KERNELS)
    flow = build_coupled(dev)
    twin = share_parameters(build_coupled(dev, kernel_inverse=True), flow)
    engine = FlowServeEngine(flow, device=dev, sample_flow=twin)
    x = x_cpu.to(dev)
    reset(kernels)
    lp = engine.log_prob(x)
    torch.cuda.synchronize()
    lp_launches = {k.name: k.launches for k in kernels if k.launches}
    check(lp_launches == {"coupling_fwd": 24}, f"unrolled log_prob launches: {lp_launches}")
    lp_paths = dict(ck.coupling_fwd.launches_by_path)
    check(lp_paths == {"rows": 24, "tile": 0}, f"unrolled log_prob coupling_fwd paths: {lp_paths}")

    lp_cpu = FlowServeEngine(build_coupled("cpu"), device="cpu").log_prob(x_cpu)
    rel = ((lp.cpu() - lp_cpu).abs() / lp_cpu.abs()).max().item()
    check(torch.isfinite(lp).all().item() and rel <= TOL_LOG_PROB, f"unrolled log_prob vs cpu: {rel}")

    with torch.inference_mode():
        z_data, _ = engine.flow(x)
    like = tuple(torch.empty_like(v, device="meta") for v in z_data)
    gen = torch.Generator().manual_seed(SEED + 3)
    reset(kernels)
    samples = engine.sample(gen, like)
    torch.cuda.synchronize()
    s_launches = {k.name: k.launches for k in kernels if k.launches}
    check(s_launches == {"coupling_inv": 24}, f"unrolled sample launches: {s_launches}")
    s_paths = dict(ck.coupling_inv.launches_by_path)
    check(s_paths == {"rows": 24, "tile": 0}, f"unrolled sample coupling_inv paths: {s_paths}")
    lp_s = engine.log_prob(samples)
    z = std_normal_sample(derive_key(gen, 0, dev), like)
    with torch.inference_mode():
        z_back, _ = engine.flow(samples)
    rt = max((a - b).abs().max().item() for a, b in zip(z_back, z))
    check(torch.isfinite(samples).all().item() and torch.isfinite(lp_s).all().item(),
          "unrolled samples or their log_prob not finite")
    check(rt <= TOL_ROUND_TRIP, f"unrolled forward(inverse(z)) vs z: {rt}")
    line("serve", model="GLOW_COUPLED", image=[BATCH, HW, HW, 3], log_prob_mean=lp.mean().item(),
         log_prob_rel_err_vs_cpu=rel, sample_shape=list(samples.shape),
         sample_log_prob_mean=lp_s.mean().item(), round_trip_max_abs_err=rt,
         twin_shares_parameters=all(a is b for a, b in zip(flow.parameters(), twin.parameters())),
         launches={"log_prob": lp_launches, "sample": s_launches},
         launches_by_path={"log_prob": {"coupling_fwd": lp_paths},
                           "sample": {"coupling_inv": s_paths}}, card=card)
    return {"engine": engine, "x": x, "like": like,
            "launches": {"coupling_fwd": lp_launches.get("coupling_fwd", 0),
                         "coupling_inv": s_launches.get("coupling_inv", 0)}}


def coupled_train_phase(dev, card) -> dict:
    """Phase 4, unrolled: one ``GLOW_COUPLED`` train step on the card (the
    fused coupling kernels, the ActNorm and Conv1x1 hooks) against the CPU
    and against ``autodiff`` on the card, then ``train_flow``."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.train.loop import train_flow

    kernels = (*fk.KERNELS, *ck.KERNELS, *c1k.KERNELS)
    data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED)
    x_cpu = data.batch_at(0)
    x = x_cpu.to(dev)
    flow = build_coupled(dev)
    check(flow.engine == "coupled", f"GLOW_COUPLED engine: {flow.engine}")
    reset(kernels)
    loss, grads = value_and_grad_nll(flow, x)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels if k.launches}
    check(launches == {"coupling_fwd": 24, "coupling_bwd": 24},
          f"unrolled train-step launches: {launches}")
    paths = dict(ck.coupling_fwd.launches_by_path)
    check(paths == {"rows": 24, "tile": 0}, f"unrolled train-step coupling_fwd paths: {paths}")
    bwd_paths = dict(ck.coupling_bwd.launches_by_path)
    check(bwd_paths == {"rows": 24, "tile": 0},
          f"unrolled train-step coupling_bwd paths: {bwd_paths}")

    t0 = time.perf_counter()
    loss_cpu, grads_cpu = value_and_grad_nll(build_coupled("cpu"), x_cpu)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    grad_rel, grad_worst = max_rel_leaf_err(grads, grads_cpu)
    check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL,
          f"unrolled train loss vs cpu: {loss_rel}")
    check(all(torch.isfinite(g).all().item() for g in grads.values()), "unrolled gradients not finite")
    check(grad_rel <= TOL_GRAD_REL, f"unrolled gradient vs cpu: {grad_rel} at {grad_worst}")
    oracle = float64_oracle(dev, x_cpu, grads, grads_cpu)
    del grads_cpu

    flow_ad = build_coupled(dev, grad_mode="autodiff")  # plain autograd, no kernel
    loss_ad, grads_ad = value_and_grad_nll(flow_ad, x)
    ad_rel, ad_worst = max_rel_leaf_err(grads, grads_ad)
    ad_loss_rel = abs(loss.item() - loss_ad.item()) / abs(loss_ad.item())
    check(ad_loss_rel <= TOL_LOSS_REL and ad_rel <= TOL_GRAD_REL,
          f"coupled vs autodiff on the card: loss {ad_loss_rel}, grad {ad_rel} at {ad_worst}")
    del flow_ad, grads_ad

    res = train_flow(build_coupled(dev), data, TrainConfig(steps=TRAIN_STEPS), device=dev)
    first_rel = abs(res.losses[0] - loss.item()) / abs(loss.item())
    check(len(res.losses) == TRAIN_STEPS and all(math.isfinite(v) for v in res.losses),
          f"unrolled train_flow losses: {res.losses}")
    check(first_rel <= 1e-6, f"unrolled train_flow step 0 loss {res.losses[0]} vs {loss.item()}")
    line("train", model="GLOW_COUPLED", image=[BATCH, HW, HW, 3], loss=loss.item(),
         loss_rel_err_vs_cpu=loss_rel, grad_max_rel_err_vs_cpu=grad_rel,
         grad_worst_leaf_vs_cpu=grad_worst, cpu_reference_s=cpu_s,
         loss_rel_err_vs_autodiff=ad_loss_rel, grad_max_rel_err_vs_autodiff=ad_rel,
         **oracle, launches_per_train_step=launches,
         coupling_fwd_launches_by_path=paths, coupling_bwd_launches_by_path=bwd_paths,
         train_flow_losses=res.losses, n_params=sum(p.numel() for p in flow.parameters()),
         card=card)
    return {"launches": launches, "flow": flow, "x": x}


# cHINT (CHINT_COUPLED: depth 4, hidden 128, recursion 2) at the reference's
# seismic-uq widths (src/repro/uq/scenarios.py:142): d_theta 32, d_y 32, a
# summary of 64 out and 128 hidden, batch 256; a draw of 2048 posterior
# samples and a sample of 20,000 for one observation
CHINT_D_THETA, CHINT_D_Y, CHINT_SUMMARY, CHINT_SUMMARY_HIDDEN = 32, 32, 64, 128
CHINT_BATCH, CHINT_DRAW, CHINT_SAMPLE = 256, 2048, 20_000
# the cross nodes of one HINT block at c = 32, recursion 2: the root (cb 16)
# and two c = 16 children (cb 8); 4 blocks, so 12 coupling_bwd a train step
# and 12 coupling_inv a draw
CHINT_CROSS_NODES = 12
TOL_CHINT_LOSS_REL = 1e-4  # the train loss on the card against the CPU


def build_chint_model(device, seed=SEED + 40):
    """``CHINT_COUPLED`` with a ``SummaryMLP`` and the ``kernel_inverse=True``
    sampling twin, from the seed on the CPU, then on ``device``; the flow
    and the summary perturbed (their last layers start at zero: every
    coupling the identity, the summary's output 0 and its inner layers
    without a gradient)."""
    import torch
    from repro_torch.configs.flows import CHINT_COUPLED
    from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint

    cfg = CHINT_COUPLED
    g = torch.Generator().manual_seed(seed)
    kw = dict(depth=cfg.depth, hidden=cfg.hidden, generator=g, device="cpu")
    flow = build_chint(CHINT_D_THETA, CHINT_SUMMARY, grad_mode=cfg.grad_mode, **kw)
    twin = build_chint(CHINT_D_THETA, CHINT_SUMMARY, kernel_inverse=True, **kw)
    summary = SummaryMLP(CHINT_D_Y, CHINT_SUMMARY, CHINT_SUMMARY_HIDDEN, generator=g, device="cpu")
    perturb(flow, seed + 1, stacked=False)
    perturb(summary, seed + 2, stacked=False)
    return ConditionalFlow(flow, summary, sample_flow=twin, device=device)


def chint_phase(dev, card) -> dict:
    """Phase 5b: cHINT amortized posteriors on the card.  (a) one coupled
    train step at full width against the CPU, 12 ``coupling_bwd`` on the
    half kernel and no ``coupling_fwd``; (b) ``posterior_sampler`` (n =
    2048) and ``sample`` (n = 20,000) through the ``kernel_inverse`` twin,
    12 ``coupling_inv`` a call, against the plain inverse of the same z and
    cond, the same bits for the same seed, the round trip; (c) 12 steps
    through ``train_conditional_flow`` with checkpoints every 4, a failure
    at step 6 and no prefetch, bitwise against an uninterrupted run with
    ``prefetch=2``, one save of the final step each (the ``lg-posterior``
    recipe against the analytic posterior runs in ``[examples]``, as
    ``examples/torch_amortized_inference.py``).  Then wall and device-busy
    ms of a train step and a draw, and the two kernels at this path's
    shapes."""
    import shutil
    import tempfile

    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import derive_key
    from repro_torch.data.synthetic import SyntheticInverseProblem
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling.ref import (coupling_bwd_ref, coupling_bwd_rows_ref,
                                                  coupling_inv_ref, coupling_inv_rows_ref)
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.loop import objective_value_and_grad, train_conditional_flow

    out: dict = {"launches": {}}
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_chint_"))
    try:
        # (a) one train step, card against CPU --------------------------------
        data = SyntheticInverseProblem(CHINT_D_THETA, CHINT_D_Y, sigma=0.02, batch=CHINT_BATCH,
                                       seed=SEED)
        batch_cpu = data.batch_at(0)
        model_cpu = build_chint_model("cpu")
        model = build_chint_model(dev)
        check(model.flow.engine == "coupled",
              "CHINT_COUPLED does not train through the coupled engine")
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        step_vg = objective_value_and_grad(model, model.train_loss)
        reset(ck.KERNELS)
        loss, grads = step_vg(batch)
        torch.cuda.synchronize()
        step_paths = {k.name: dict(k.launches_by_path) for k in ck.KERNELS}
        check(step_paths == {"coupling_fwd": {"rows": 0, "tile": 0},
                             "coupling_inv": {"rows": 0, "tile": 0},
                             "coupling_bwd": {"rows": 0, "tile": CHINT_CROSS_NODES}},
              f"cHINT train-step launches: {step_paths}")
        loss_cpu, grads_cpu = objective_value_and_grad(model_cpu, model_cpu.train_loss)(batch_cpu)
        loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
        grad_rel, grad_worst = max_rel_leaf_err(grads, grads_cpu)
        check(torch.isfinite(loss).item() and loss_rel <= TOL_CHINT_LOSS_REL,
              f"cHINT train loss vs cpu: {loss_rel}")
        check(all(torch.isfinite(g).all().item() for g in grads.values()),
              "cHINT gradients not finite")
        check(grad_rel <= TOL_GRAD_REL, f"cHINT gradient vs cpu: {grad_rel} at {grad_worst}")
        summary_rel, _ = max_rel_leaf_err({k: v for k, v in grads.items() if "summary" in k},
                                          {k: v for k, v in grads_cpu.items() if "summary" in k})
        check(any("summary" in k for k in grads) and all(
            grads[k].abs().max().item() > 0 for k in grads if k.startswith("summary.layers.0")),
            "the summary network got no gradient")
        out["launches"]["coupling_bwd"] = step_paths["coupling_bwd"]["tile"]
        line("chint", part="train_step_vs_cpu", model="CHINT_COUPLED",
             widths={"d_theta": CHINT_D_THETA, "d_y": CHINT_D_Y, "summary": CHINT_SUMMARY,
                     "summary_hidden": CHINT_SUMMARY_HIDDEN, "batch": CHINT_BATCH},
             loss=loss.item(), loss_rel_err_vs_cpu=loss_rel, grad_max_rel_err_vs_cpu=grad_rel,
             grad_worst_leaf_vs_cpu=grad_worst, summary_grad_max_rel_err_vs_cpu=summary_rel,
             launches_by_path_per_train_step=step_paths,
             n_params=sum(p.numel() for p in model.parameters()), card=card)

        # (b) posterior sampling through the kernel_inverse twin --------------
        y_obs = data.batch_at(10_000)["y"][:1]
        sampler = model.posterior_sampler(y_obs, theta_dim=CHINT_D_THETA)
        with torch.no_grad():
            cond0 = model._cond(y_obs)
        sampled = {}
        for what, n, run in (("posterior_sampler", CHINT_DRAW, lambda g, n: sampler(g, n)),
                             ("sample", CHINT_SAMPLE,
                              lambda g, n: model.sample(g, y_obs, n, CHINT_D_THETA))):
            gen = torch.Generator().manual_seed(SEED + 42)
            reset(ck.KERNELS)
            x = run(gen, n)
            torch.cuda.synchronize()
            paths = {k.name: dict(k.launches_by_path) for k in ck.KERNELS}
            check(paths == {"coupling_fwd": {"rows": 0, "tile": 0},
                            "coupling_inv": {"rows": 0, "tile": CHINT_CROSS_NODES},
                            "coupling_bwd": {"rows": 0, "tile": 0}},
                  f"cHINT {what} launches: {paths}")
            again = run(torch.Generator().manual_seed(SEED + 42), n)
            other = run(torch.Generator().manual_seed(SEED + 43), n)
            with torch.no_grad():
                z = torch.randn((n, CHINT_D_THETA), generator=derive_key(gen, 0, dev), device=dev)
                cond = cond0.repeat_interleave(n, dim=0)
                plain = model.flow.inverse(z, cond)
                z_back, _ = model.flow(x, cond)
            err = (x - plain).abs().max().item()
            rt = (z_back - z).abs().max().item()
            check(x.shape == (n, CHINT_D_THETA) and torch.isfinite(x).all().item(),
                  f"cHINT {what}: shape {tuple(x.shape)} or not finite")
            check(err <= TOL_F32, f"cHINT {what} vs the plain inverse: {err}")
            check(torch.equal(x, again) and not torch.equal(x, other),
                  f"cHINT {what}: the same seed gave other bits, or another seed the same")
            check(rt <= TOL_ROUND_TRIP, f"cHINT {what} forward(inverse(z)) vs z: {rt}")
            sampled[what] = {"n": n, "max_abs_err_vs_plain_inverse": err,
                             "round_trip_max_abs_err": rt, "same_seed_bitwise_equal": True,
                             "launches_by_path": paths}
        out["launches"]["coupling_inv"] = CHINT_CROSS_NODES
        line("chint", part="sampling", y_obs_index=10_000, **sampled, card=card)

        # (c) a restart reproduces the uninterrupted run, bit for bit ----------
        saves: list = []
        real_save = ckpt.save

        def counting_save(state, ckpt_dir, step, keep=3):
            saves.append((Path(ckpt_dir).name, step))
            return real_save(state, ckpt_dir, step, keep)

        ckpt.save = counting_save
        try:
            runs = {}
            for name, prefetch, injector in (("uninterrupted", 2, None),
                                             ("restarted", 0, FailureInjector(fail_at=(6,)))):
                cfg = TrainConfig(steps=12, lr=1e-3, warmup_steps=2, checkpoint_every=4,
                                  checkpoint_dir=str(scratch / name), prefetch=prefetch)
                runs[name] = train_conditional_flow(build_chint_model(dev), data, cfg,
                                                    device=dev, injector=injector)
        finally:
            ckpt.save = real_save
        a, b = runs["uninterrupted"], runs["restarted"]
        same = (all(torch.equal(a.params[k], b.params[k]) for k in a.params)
                and all(torch.equal(a.opt_state[m][k], b.opt_state[m][k])
                        for m in ("mu", "nu") for k in a.opt_state[m])
                and a.opt_state["step"] == b.opt_state["step"] == 12)
        unequal = [k for k in a.params if not torch.equal(a.params[k], b.params[k])]
        by_run = {n: [s for d, s in saves if d == n] for n in runs}
        check(b.restarts == 1 and a.restarts == 0, f"cHINT restarts: {a.restarts}, {b.restarts}")
        check(same, f"cHINT restarted run differs from the uninterrupted one: {unequal[:5]}")
        check(b.losses == a.losses[4:], "cHINT restarted losses differ")
        check(all(v.count(11) == 1 for v in by_run.values()) and by_run["uninterrupted"]
              == [3, 7, 11], f"cHINT checkpoint saves: {by_run}")
        line("chint", part="restart", steps=12, checkpoint_every=4, fail_at=6,
             restarts=b.restarts, final_state_bitwise_equal=same, saves=by_run,
             uninterrupted_prefetch=2, restarted_prefetch=0, losses=a.losses, card=card)

        # wall and device-busy ms of a train step and of the draws -----------
        params = dict(model.named_parameters())
        opt = adamw_init(params)
        train_cfg = TrainConfig()

        def train_step():
            loss_, grads_ = step_vg(batch)
            adamw_update(params, grads_, opt, train_cfg, 1e-5)
            return loss_

        gen = torch.Generator().manual_seed(SEED + 44)
        for what, fn in (("train_step", train_step),
                         ("posterior_sampler_draw", lambda: sampler(gen, CHINT_DRAW)),
                         ("sample", lambda: model.sample(gen, y_obs, CHINT_SAMPLE,
                                                         CHINT_D_THETA))):
            median, runs_ms = e2e_wall_ms(fn)
            busy_ms, idle, _ = profile_call(fn, median, f"chint_{what}")
            line("chint", part="times", call=what, median_ms=median,
                 q1_ms=sorted(runs_ms)[len(runs_ms) // 4],
                 q3_ms=sorted(runs_ms)[(3 * len(runs_ms)) // 4], device_busy_ms=busy_ms,
                 device_idle_share=idle, card=card)

        # each kernel at this path's shapes: the half kernels (M = 1) --------
        times = {"coupling_bwd": [], "coupling_inv": []}
        for name, shapes in (("coupling_bwd", [(CHINT_BATCH, 1, 16), (CHINT_BATCH, 1, 8)]),
                             ("coupling_inv", [(CHINT_SAMPLE, 1, 16), (CHINT_SAMPLE, 1, 8),
                                               (CHINT_DRAW, 1, 16), (CHINT_DRAW, 1, 8)])):
            for shape in shapes:
                b, m, cb = shape
                gt = torch.Generator().manual_seed(SEED + 45)
                state = torch.randn(b, 2 * cb, generator=gt).to(dev)
                h = torch.randn(b, m, 2 * cb, generator=gt).to(dev)
                v = state[:, cb:].reshape(shape)  # a strided half, as a node passes it
                raw, t = h[..., :cb], h[..., cb:]
                check(ck.coupling_path(v, raw, t) == "tile", f"{name} at {shape} off the tile path")
                if name == "coupling_bwd":
                    gy = torch.randn(shape, generator=gt).to(dev)
                    gld = torch.randn(b, generator=gt).to(dev)
                    got = ck.coupling_bwd.rows(v, h, gy, gld)
                    ref = coupling_bwd_rows_ref(v, h, gy, gld)
                    k_fn = lambda: ck.coupling_bwd(v, raw, t, gy, gld)  # noqa: E731
                    p_fn = lambda: coupling_bwd_ref(v, raw, t, gy, gld)  # noqa: E731
                    op_fn = lambda: ck.coupling_bwd.rows(v, h, gy, gld)  # noqa: E731
                else:
                    got, ref = (ck.coupling_inv.rows(v, h),), (coupling_inv_rows_ref(v, h),)
                    k_fn = lambda: ck.coupling_inv(v, raw, t)  # noqa: E731
                    p_fn = lambda: coupling_inv_ref(v, raw, t)  # noqa: E731
                    op_fn = lambda: ck.coupling_inv.rows(v, h)  # noqa: E731
                err = max((a - r).abs().max().item() for a, r in zip(got, ref))
                check(err <= TOL_F32, f"{name} at {shape}: {err}")
                op_ms, _, op_split = device_ms(op_fn)
                times[name].append(time_kernel(
                    f"{name}_half" if name == "coupling_bwd" else name, shape, torch.float32,
                    k_fn, p_fn, path="tile", path_of="chint", max_abs_err=err,
                    row_op_ms=op_ms, row_op_ms_by_kernel=op_split, card=card))
        out["times"] = times
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return out


# The examples (phase 5d): the port's five entry points through their main.
#: reversible_lm at revlm-100m's full width, steps cut from the example's 300
#: for the script's time limit; its gate (the last loss below the first)
#: reads the first and the last step only
EXAMPLE_LM_STEPS = 20
#: seismic_uq's steps, cut from the recipe's 1000 (80.4 s on an H100 with
#: its report) for the script's time limit: its gate, a finite posterior mean,
#: holds at any count (20 steps on the CPU); phase 5c takes the run over
EXAMPLE_SEISMIC_STEPS = 100


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util

    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each with its launch count)."""
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.flowstep import flowstep as fk
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.ssd import ssd as sk

    return (*fk.KERNELS, *ck.KERNELS, *c1k.KERNELS, *ak.KERNELS, *rk.KERNELS, *sk.KERNELS)


def _example_gates(name: str, res: dict) -> dict:
    """The numbers each example's own gates read."""
    if name == "quickstart":
        return {"nll": res["nll"], "nll_gate": 1.2, "round_trip_max_err": res["round_trip_max_err"]}
    if name == "train_glow":
        return {k: res[k] for k in ("final_step", "first_loss", "last_loss", "bits_per_dim",
                                    "sample_shape", "sample_range")}
    if name == "reversible_lm":
        return {"n_params": res["n_params"], "steps": res["steps"], "first_loss":
                res["first_loss"], "last_loss": res["last_loss"],
                "generated_shape": list(res["tokens"].shape)}
    if name == "amortized_inference":
        return {"steps": res["steps"], "mu_err": res["mu_err"], "mu_err_gate": 0.35,
                "sd_ratio_min_max": [min(res["sd_ratio"]), max(res["sd_ratio"])],
                "sd_ratio_gate": [0.5, 2.0], "draws": res["draws"],
                "sbc_pvalue_min": res["sbc_pvalue_min"], "first_loss": res["losses"][0],
                "last_loss": res["losses"][-1]}
    stats = res["stats"]
    return {"steps": res["steps"], "posterior_mean_finite": bool(all(
        math.isfinite(v) for v in stats.mean.tolist())), "draws": stats.n,
            "width_vs_analytic_std_corr": res["width_vs_analytic_std_corr"],
            "first_loss": res["run"].result.losses[0], "last_loss": res["run"].result.losses[-1]}


def examples_phase(dev, card, scratch) -> dict:
    """Phase 5d ``[examples]``: each of ``examples/torch_*.py`` through its
    ``main`` on the card (docstring above), its launches counted from 0 just
    before and read just after.  Returns the launches by example and the
    seismic run for phase 5c."""
    import torch

    seismic_ck = str(scratch / "seismic-uq")
    runs = (
        ("quickstart", "quickstart", {}, ("coupling_fwd",)),
        ("train_glow", "train_glow --scanned", {"scanned": True, "ckpt": str(scratch / "glow_s")},
         ("flowstep_fwd", "flowstep_inv")),
        ("train_glow", "train_glow --grad-mode coupled",
         {"grad_mode": "coupled", "ckpt": str(scratch / "glow_u")},
         ("coupling_fwd", "coupling_bwd")),
        ("reversible_lm", f"reversible_lm --steps {EXAMPLE_LM_STEPS}",
         {"steps": EXAMPLE_LM_STEPS, "ckpt": str(scratch / "revlm")}, ()),
        ("amortized_inference", "amortized_inference", {}, ("coupling_bwd", "coupling_inv")),
        ("seismic_uq", "seismic_uq", {"steps": EXAMPLE_SEISMIC_STEPS, "ckpt_dir": seismic_ck},
         ("coupling_bwd", "coupling_inv")),
    )
    kernels = all_kernels()
    launches, seismic = {}, None
    for name, what, kwargs, needs in runs:
        module = load_example(name)
        gc.collect()
        torch.cuda.empty_cache()
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = module.main(device=dev, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels if k.launches}
        by_path = {k.name: {p: n for p, n in k.launches_by_path.items() if n}
                   for k in kernels if k.launches and hasattr(k, "launches_by_path")}
        launches[what] = counts
        line("examples", example=f"examples/torch_{name}.py", run=what, gates=_example_gates(
            name, res), launches=counts, launches_by_path=by_path, seconds=seconds, card=card)
        check(all(counts.get(k, 0) > 0 for k in needs),
              f"examples: {what} did not launch {needs}: {counts}")
        if name == "seismic_uq":
            seismic = {"run": res["run"], "steps": res["steps"], "ckpt_dir": seismic_ck,
                       "launches_by_path": by_path, "seconds": seconds}
        del res, module
    return {"launches": launches, "seismic": seismic}


# UQ (phase 5c).  (a) RealNVP: REALNVP_2D as the reference builds it (the
# invertible engine, no kernel) at D = 2, and the kernel path (depth 8,
# hidden 128, coupled, kernel_training) at D = 32, the tabular shape of
# tests/test_autodiff.py:170, batch 4096; peak memory at depth 2, 8, 24.
# (b) HYPERBOLIC_DEEP (16 leapfrog layers of 3x3 convolutions, coupled) on
# the pair state of 8 x 256x256x3 images; peak memory at depth 16 and 32.
# (c) the seismic-uq scenario (src/repro/uq/scenarios.py:129) trained,
# restored and reported; the two image-prior scenarios at their widths, steps
# cut to a few.  (d) the launchers as subprocesses.
UQ_BATCH = 4096
REALNVP_KERNEL = dict(d=32, depth=8, hidden=128)
REALNVP_MEM_DEPTHS = (2, 8, 24)
HYPER_MEM_DEPTHS = (16, 32)
# cut from the recipes' 300: the cut shrinks the warmup to 2 steps (a 20th
# of the steps, at least 2), and at the full learning rate from step 2 on
# both the reference and the port diverge (loss ~1e21 at step 3 at 16x16)
PRIOR_STEPS = 2
PRIOR_SAMPLES = 2048
TOL_UQ_LOSS_REL = 1e-4      # the train loss on the card against the CPU
TOL_STREAM_REL = 1e-6       # streamed moments against the chunks concatenated


def peak_step_bytes(flow, x) -> tuple[int, int]:
    """Peak device bytes of one train step of ``flow`` at ``x`` (the value
    and gradient of the NLL, then the AdamW update), and the bytes allocated
    when it started."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import value_and_grad_nll
    from repro_torch.optim import adamw_init, adamw_update

    params = dict(flow.named_parameters())
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    _loss, grads = value_and_grad_nll(flow, x)
    adamw_update(params, grads, opt, TrainConfig(), 1e-4)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), start


def memory_growth(phase_part, card, build, x, depths, modes) -> dict:
    """Peak bytes of a train step at each depth under each engine, and the
    reversible engine's growth against autodiff's (the quarter rule of the
    ``[memory]`` phase)."""
    import torch

    peaks = {}
    for mode in modes:
        for depth in depths:
            flow = build(depth, mode)
            peaks[f"{mode}_depth{depth}"] = peak_step_bytes(flow, x)[0]
            del flow
            gc.collect()
            torch.cuda.empty_cache()
    growth = {m: peaks[f"{m}_depth{depths[-1]}"] - peaks[f"{m}_depth{depths[0]}"] for m in modes}
    line("uq", part=phase_part, peaks_bytes=peaks,
         growth_bytes={f"{m}_depth{depths[0]}_to_{depths[-1]}": g for m, g in growth.items()},
         card=card)
    check(growth[modes[0]] < 0.25 * growth["autodiff"],
          f"{phase_part}: {modes[0]} peak grew {growth[modes[0]]} B, autodiff {growth['autodiff']} B")
    return growth


def step_vs_cpu(flow, flow_cpu, x, x_cpu):
    """One train step on the card against the same weights on the CPU:
    (loss, relative loss error, worst leaf's error of its largest entry, the
    leaf, the card's gradients)."""
    import torch
    from repro_torch.core import value_and_grad_nll

    loss, grads = value_and_grad_nll(flow, x)
    torch.cuda.synchronize()
    loss_cpu, grads_cpu = value_and_grad_nll(flow_cpu, x_cpu)
    loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    grad_rel, worst = max_rel_leaf_err(grads, grads_cpu)
    check(torch.isfinite(loss).item() and all(torch.isfinite(g).all().item()
                                              for g in grads.values()), "loss or grads not finite")
    return loss, loss_rel, grad_rel, worst, grads


def uq_realnvp(dev, card, out):
    """(a): both RealNVP builds, a train step on the card against the CPU,
    the round trip, the launches; then the memory in depth."""
    import torch
    from repro_torch.configs.flows import REALNVP_2D, build_flow
    from repro_torch.core import build_realnvp
    from repro_torch.kernels.coupling import coupling as ck

    builds = (
        ("REALNVP_2D", 2, lambda device: build_flow(
            REALNVP_2D, generator=torch.Generator().manual_seed(SEED + 60), device=device)),
        ("realnvp_kernel_training", REALNVP_KERNEL["d"], lambda device: build_realnvp(
            REALNVP_KERNEL["d"], depth=REALNVP_KERNEL["depth"], hidden=REALNVP_KERNEL["hidden"],
            grad_mode="coupled", kernel_training=True,
            generator=torch.Generator().manual_seed(SEED + 61), device=device)),
    )
    for label, d, build in builds:
        flow_cpu = build("cpu")
        perturb(flow_cpu, SEED + 62, stacked=False)
        flow = copy.deepcopy(flow_cpu).to(dev)
        kernel_path = label != "REALNVP_2D"
        g = torch.Generator().manual_seed(SEED + 63)
        x_cpu = torch.randn(UQ_BATCH, d, generator=g)
        x = x_cpu.to(dev)
        reset(ck.KERNELS)
        loss, loss_rel, grad_rel, worst, _ = step_vs_cpu(flow, flow_cpu, x, x_cpu)
        paths = {k.name: dict(k.launches_by_path) for k in ck.KERNELS}
        n = REALNVP_KERNEL["depth"] if kernel_path else 0
        want = {"coupling_fwd": {"rows": 0, "tile": n}, "coupling_inv": {"rows": 0, "tile": 0},
                "coupling_bwd": {"rows": 0, "tile": n}}
        check(paths == want, f"{label} train-step launches: {paths}")
        check(loss_rel <= TOL_UQ_LOSS_REL, f"{label} loss vs cpu: {loss_rel}")
        check(grad_rel <= TOL_GRAD_REL, f"{label} gradient vs cpu: {grad_rel} at {worst}")
        with torch.no_grad():
            z, _ = flow(x)
            rt = (flow.inverse(z) - x).abs().max().item()
        check(rt <= TOL_ROUND_TRIP, f"{label} inverse(forward(x)) vs x: {rt}")
        if kernel_path:
            out["launches"]["realnvp_train_step"] = {k: v["tile"] for k, v in paths.items()}
        line("uq", part="realnvp", build=label, d=d, batch=UQ_BATCH, engine=flow.engine,
             kernel_training=kernel_path, loss=loss.item(), loss_rel_err_vs_cpu=loss_rel,
             grad_max_rel_err_vs_cpu=grad_rel, grad_worst_leaf_vs_cpu=worst,
             round_trip_max_abs_err=rt, launches_by_path_per_train_step=paths, card=card)
        del flow, flow_cpu
    x = torch.randn(UQ_BATCH, REALNVP_KERNEL["d"],
                    generator=torch.Generator().manual_seed(SEED + 64)).to(dev)
    memory_growth("realnvp_memory", card, lambda depth, mode: build_realnvp(
        REALNVP_KERNEL["d"], depth=depth, hidden=REALNVP_KERNEL["hidden"], grad_mode=mode,
        generator=torch.Generator().manual_seed(SEED + 65), device=dev),
        x, REALNVP_MEM_DEPTHS, ("invertible", "autodiff"))


def uq_hyperbolic(dev, card):
    """(b): ``HYPERBOLIC_DEEP`` on the pair state of the Fig. 1 input, a
    train step against the CPU and against autodiff on the card, the round
    trip; then the memory in depth."""
    import torch
    from repro_torch.configs.flows import HYPERBOLIC_DEEP, build_flow
    from repro_torch.core import build_hyperbolic, value_and_grad_nll

    def build(device, grad_mode=None):
        return build_flow(HYPERBOLIC_DEEP, grad_mode, channels=3,
                          generator=torch.Generator().manual_seed(SEED + 70), device=device)

    g = torch.Generator().manual_seed(SEED + 71)
    x_cpu = tuple(torch.rand((BATCH, HW, HW, 3), generator=g) - 0.5 for _ in range(2))
    x = tuple(v.to(dev) for v in x_cpu)
    flow = build(dev)
    check(flow.engine == "coupled" and len(flow.layers) == HYPERBOLIC_DEEP.depth,
          "HYPERBOLIC_DEEP does not train through the coupled engine")
    t0 = time.perf_counter()
    loss, loss_rel, grad_rel, worst, grads = step_vs_cpu(flow, build("cpu"), x, x_cpu)
    cpu_s = time.perf_counter() - t0
    loss_ad, grads_ad = value_and_grad_nll(build(dev, "autodiff"), x)
    ad_rel, ad_worst = max_rel_leaf_err(grads, grads_ad)
    ad_loss_rel = abs(loss.item() - loss_ad.item()) / abs(loss_ad.item())
    check(loss_rel <= TOL_UQ_LOSS_REL and grad_rel <= TOL_GRAD_REL,
          f"HYPERBOLIC_DEEP vs cpu: loss {loss_rel}, grad {grad_rel} at {worst}")
    check(ad_loss_rel <= TOL_UQ_LOSS_REL and ad_rel <= TOL_GRAD_REL,
          f"HYPERBOLIC_DEEP coupled vs autodiff: loss {ad_loss_rel}, grad {ad_rel} at {ad_worst}")
    with torch.no_grad():
        z, ld = flow(x)
        rt = max((a - b).abs().max().item() for a, b in zip(flow.inverse(z), x))
    check(rt <= TOL_ROUND_TRIP and not ld.any().item(), f"HYPERBOLIC_DEEP round trip: {rt}")
    line("uq", part="hyperbolic", model="HYPERBOLIC_DEEP", state=[2, BATCH, HW, HW, 3],
         loss=loss.item(), loss_rel_err_vs_cpu=loss_rel, grad_max_rel_err_vs_cpu=grad_rel,
         grad_worst_leaf_vs_cpu=worst, loss_rel_err_vs_autodiff=ad_loss_rel,
         grad_max_rel_err_vs_autodiff=ad_rel, round_trip_max_abs_err=rt,
         z_max_abs=max(v.abs().max().item() for v in z), cpu_step_s=cpu_s, card=card)
    del flow, grads, grads_ad
    memory_growth("hyperbolic_memory", card, lambda depth, mode: build_hyperbolic(
        3, depth=depth, grad_mode=mode, generator=torch.Generator().manual_seed(SEED + 70),
        device=dev), x, HYPER_MEM_DEPTHS, ("coupled", "autodiff"))


def count_calls(obj, attr):
    """Wrap ``obj.attr`` with a call counter; returns the counter (a list)."""
    calls = [0]
    real = getattr(obj, attr)

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    setattr(obj, attr, counted)
    return calls


def uq_seismic(dev, card, out, trained):
    """(c), the conditional scenario: ``seismic-uq`` as phase 5d's
    seismic_uq example trained it (``trained``: its run, checkpoint
    directory and launches), restored bitwise, and its ``posterior_report``
    (20,000 draws in chunks of 2048, SBC and coverage at 128 x 64), the
    streamed moments against the chunks concatenated, ``coupling_inv``
    launches against the sampler calls; wall and busy of a train step, a
    chunk and the report."""
    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import flatten_state
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train.loop import objective_value_and_grad
    from repro_torch.uq import PosteriorEngine, get_scenario, posterior_report, restore_scenario

    sc = get_scenario("seismic-uq")
    run, steps = trained["run"], trained["steps"]
    bwd = trained["launches_by_path"].get("coupling_bwd", {})
    fwd = trained["launches_by_path"].get("coupling_fwd", {})
    check(bwd == {"tile": CHINT_CROSS_NODES * steps} and not fwd,
          f"seismic-uq training launches: coupling_bwd {bwd}, coupling_fwd {fwd}")
    losses = run.result.losses
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          "seismic-uq losses not finite")
    restored = restore_scenario(sc, trained["ckpt_dir"], device=dev)
    unequal = [k for k, v in run.params.items() if not torch.equal(v, restored.params[k])]
    check(not unequal and set(run.params) == set(restored.params),
          f"restored parameters differ from the trained ones: {unequal[:5]}")
    out["launches"]["seismic_train_step"] = {"coupling_bwd": CHINT_CROSS_NODES}
    line("uq", part="seismic_train", scenario=sc.name, steps=steps, recipe_steps=sc.steps,
         steps_cut=steps != sc.steps, trained_by="examples/torch_seismic_uq.py (phase 5d)",
         example_s_with_report=trained["seconds"], first_loss=losses[0], last_loss=losses[-1],
         coupling_bwd_launches_by_path=bwd, restored_bitwise_equal=True,
         n_params=sum(p.numel() for p in run.model.parameters()), card=card)

    model = restored.model
    y_obs = restored.problem.batch_at(10_000)["y"][:1]
    calls = count_calls(model.sample_flow, "inverse")
    reset(ck.KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, report = posterior_report(restored, y_obs=y_obs,
                                     generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    paths = {k.name: dict(k.launches_by_path) for k in ck.KERNELS}
    n_calls = calls[0]
    n_chunks = -(-sc.n_posterior // sc.chunk)
    # SBC, then coverage: one sampler call for each 32 simulations
    n_sim_calls = 2 * -(-sc.sbc_sims // 32)
    check(n_calls == n_chunks + n_sim_calls, f"sampler calls {n_calls}")
    check(paths == {"coupling_fwd": {"rows": 0, "tile": 0},
                    "coupling_inv": {"rows": 0, "tile": CHINT_CROSS_NODES * n_calls},
                    "coupling_bwd": {"rows": 0, "tile": 0}}, f"posterior_report launches: {paths}")
    chunks = list(PosteriorEngine(model, y=y_obs, theta_dim=sc.make_operator().d_theta)
                  .sample_chunks(torch.Generator().manual_seed(0), sc.n_posterior, sc.chunk))
    flat = np.concatenate(chunks).astype(np.float64)
    mean_rel = float(np.abs(stats.mean - flat.mean(0)).max() / np.abs(flat.mean(0)).max())
    var_rel = float(np.abs(stats.var - flat.var(0, ddof=1)).max() / flat.var(0, ddof=1).max())
    check(mean_rel <= TOL_STREAM_REL and var_rel <= TOL_STREAM_REL,
          f"streamed moments vs the chunks concatenated: mean {mean_rel}, var {var_rel}")
    finite = all(np.all(np.isfinite(v)) for v in (
        stats.mean, stats.std, *stats.quantiles.values(), *stats.intervals[0.9],
        report.pvalues, list(report.coverage.values())))
    check(finite, "a posterior statistic is not finite")
    mu, cov = restored.problem.posterior(y_obs[0])
    ratio = stats.std / np.sqrt(np.diag(cov))
    out["launches"]["sampler_call"] = {"coupling_inv": CHINT_CROSS_NODES}
    line("uq", part="seismic_report", draws=stats.n, chunk=sc.chunk, chunks=n_chunks,
         sbc=[sc.sbc_sims, sc.sbc_draws], sampler_calls=n_calls, launches_by_path=paths,
         streamed_vs_concatenated_rel={"mean": mean_rel, "var": var_rel},
         posterior_mean_max_abs_err=float(np.abs(stats.mean - mu).max()),
         posterior_std_ratio_min_max=[float(ratio.min()), float(ratio.max())],
         sbc_pvalue_min=float(report.pvalues.min()),
         sbc_pvalues=[round(float(p), 4) for p in report.pvalues],
         coverage=report.coverage, calibration_passed=report.passed,
         peak_host_bytes=stats.peak_bytes, stream_bytes=stats.stream_bytes,
         report_wall_s=report_s, card=card)

    # wall and device-busy ms: a train step, one chunk, the whole report
    batch = {k: v.to(dev) for k, v in restored.problem.batch_at(0).items()}
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    step_vg = objective_value_and_grad(model, model.train_loss)
    draw = model.posterior_sampler(y_obs, theta_dim=restored.problem.d_theta)
    gen = torch.Generator().manual_seed(SEED + 80)

    def train_step():
        loss_, grads_ = step_vg(batch)
        adamw_update(params, grads_, opt, TrainConfig(), 1e-6)
        return loss_

    for what, fn in (("train_step", train_step),
                     ("chunk", lambda: flatten_state(draw(gen, sc.chunk)).cpu())):
        median, runs_ms = e2e_wall_ms(fn)
        busy_ms, idle, _ = profile_call(fn, median, f"uq_{what}")
        q = sorted(runs_ms)
        line("uq", part="times", call=what, median_ms=median, q1_ms=q[len(q) // 4],
             q3_ms=q[(3 * len(q)) // 4], device_busy_ms=busy_ms, device_idle_share=idle,
             card=card)
    report_fn = lambda: posterior_report(restored, y_obs=y_obs,  # noqa: E731
                                         generator=torch.Generator().manual_seed(1))
    busy_ms, idle, _ = profile_call(report_fn, 1e3 * report_s, "uq_report")
    line("uq", part="times", call="posterior_report", wall_ms=1e3 * report_s,
         device_busy_ms=busy_ms, device_idle_share=idle, card=card)


def uq_priors(dev, card, scratch, out):
    """(c), the prior scenarios at their widths, steps cut: trained,
    restored bitwise, and ``PRIOR_SAMPLES`` samples streamed through
    ``prior_report``, with the launches of each."""
    import numpy as np
    import torch
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.uq import get_scenario, prior_report, restore_scenario, train_scenario

    kernels = (*kern.KERNELS, *ck.KERNELS)
    for name in ("images-prior-scanned", "images-prior-coupled"):
        sc = get_scenario(name)
        scanned = sc.flow.kind == "glow_scanned"
        n_layers = sc.flow.n_scales * sc.flow.k_steps
        ckpt_dir = str(scratch / name)
        reset(kernels)
        run = train_scenario(sc, steps=PRIOR_STEPS, ckpt_dir=ckpt_dir, device=dev)
        torch.cuda.synchronize()
        train_launches = {k.name: k.launches for k in kernels}
        per_step = ({"flowstep_fwd": n_layers, "spine_bwd": n_layers, "coupling_bwd": n_layers}
                    if scanned else {"coupling_fwd": n_layers, "coupling_bwd": n_layers})
        want = {k.name: per_step.get(k.name, 0) * PRIOR_STEPS for k in kernels}
        check(train_launches == want, f"{name} training launches: {train_launches}")
        train_paths = {k.name: dict(k.launches_by_path) for k in kernels if k.launches}
        restored = restore_scenario(sc, ckpt_dir, device=dev)
        check(all(torch.equal(v, restored.params[k]) for k, v in run.params.items()),
              f"{name}: restored parameters differ from the trained ones")
        reset(kernels)
        stats = prior_report(restored, n_samples=PRIOR_SAMPLES,
                             generator=torch.Generator().manual_seed(SEED + 81))
        torch.cuda.synchronize()
        chunks = -(-PRIOR_SAMPLES // (sc.batch * 16))
        sample_launches = {k.name: k.launches for k in kernels}
        sampler = "flowstep_inv" if scanned else "coupling_inv"
        want = {k.name: n_layers * chunks if k.name == sampler else 0 for k in kernels}
        check(sample_launches == want, f"{name} sampling launches: {sample_launches}")
        check(np.all(np.isfinite(stats.mean)) and np.all(np.isfinite(stats.std)),
              f"{name}: sample statistics not finite")
        out["launches"][f"{name}_train_step"] = per_step
        out["launches"][f"{name}_chunk"] = {sampler: n_layers}
        line("uq", part="prior", scenario=name, image=[sc.batch, sc.image_size, sc.image_size, 3],
             steps=PRIOR_STEPS, recipe_steps=sc.steps, losses=run.result.losses,
             launches_train=train_launches, launches_by_path_train=train_paths,
             samples=stats.n, chunk=sc.batch * 16, launches_sampling=sample_launches,
             launches_by_path_sampling={k.name: dict(k.launches_by_path) for k in kernels
                                        if k.launches},
             sample_mean_range=[float(stats.mean.min()), float(stats.mean.max())],
             sample_std_range=[float(stats.std.min()), float(stats.std.max())],
             restored_bitwise_equal=True, card=card)


def uq_launchers(card, scratch):
    """(d): the launchers as subprocesses on the card, each to exit 0: the
    ``lg-smoke`` training, then its service, beside the ``yi-6b`` service
    (two chains at once, for the script's time limit)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ckpt_dir = str(scratch / "lg-smoke")
    # 8 of lg-smoke's 50 steps (all 50 until the examples needed the time)
    chains = ([["repro_torch.launch.train", "--scenario", "lg-smoke", "--steps", "8",
                "--ckpt", ckpt_dir],
               ["repro_torch.launch.serve", "--scenario", "lg-smoke", "--ckpt", ckpt_dir,
                "--samples", "4096"]],
              [["repro_torch.launch.serve", "--arch", "yi-6b", "--reduced"]])

    def run(chain, results):
        for argv in chain:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                                  cwd=ROOT, env=env, timeout=300)
            results.append((argv, proc, time.perf_counter() - t0))
            if proc.returncode:
                return

    results = [[] for _ in chains]
    threads = [threading.Thread(target=run, args=(c, r)) for c, r in zip(chains, results)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for argv, proc, seconds in (x for r in results for x in r):
        lines = proc.stdout.strip().splitlines()
        line("uq", part="launcher", argv=argv, returncode=proc.returncode, seconds=seconds,
             stdout=lines[-8:],
             stderr_tail=proc.stderr.strip().splitlines()[-5:] if proc.returncode else [],
             card=card)
        check(proc.returncode == 0 and lines, f"launcher {' '.join(argv)} exited {proc.returncode}")
    check(sum(len(r) for r in results) == 3, "a launcher chain stopped early")


def uq_times(dev, card) -> dict:
    """The coupling kernels at the new paths' shapes, and the GLOW kernels
    at the image priors' 16x16 ones (f32): RealNVP's half kernels at
    (4096, 1, 16), the streaming chunk's and the calibration's inverse at
    M = 1, and the scanned and unrolled priors' largest scale."""
    import torch
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.coupling.ref import (coupling_bwd_ref, coupling_fwd_ref,
                                                  coupling_fwd_rows_ref, coupling_inv_ref,
                                                  coupling_inv_rows_ref)
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref

    times: dict = {}
    f32 = torch.float32

    def add(kernel, name, shape, k_fn, p_fn, got, ref, **extra):
        err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
        check(err <= TOL_F32, f"{name} at {shape}: {err}")
        times.setdefault(kernel, []).append(time_kernel(
            name, shape, f32, k_fn, p_fn, path_of="uq", max_abs_err=err, card=card, **extra))

    g = torch.Generator().manual_seed(SEED + 90)
    for kernel, shapes in (("coupling_fwd", [(UQ_BATCH, 1, 16)]),
                           ("coupling_bwd", [(UQ_BATCH, 1, 16)]),
                           ("coupling_inv", [(2 * 2048, 1, 16), (2 * 2048, 1, 8),
                                             (20_000 - 9 * 2048, 1, 16)])):
        for shape in shapes:
            b, m, n = shape
            rows = torch.randn(b, 2 * n, generator=g).to(dev)
            h = torch.randn(b, m, 2 * n, generator=g).to(dev)
            v = rows[:, :n].reshape(shape)  # a strided half, as the row op passes it
            raw, t = h[..., :n], h[..., n:]
            check(ck.coupling_path(v, raw, t) == "tile", f"{kernel} at {shape} off the tile path")
            if kernel == "coupling_fwd":
                add(kernel, kernel, shape, lambda: ck.coupling_fwd(v, raw, t),
                    lambda: coupling_fwd_ref(v, raw, t), ck.coupling_fwd(v, raw, t)[:1],
                    coupling_fwd_ref(v, raw, t)[:1], path="tile", call="RealNVP forward")
            elif kernel == "coupling_bwd":
                gy = torch.randn(shape, generator=g).to(dev)
                gld = torch.randn(b, generator=g).to(dev)
                add(kernel, "coupling_bwd_half", shape,
                    lambda: ck.coupling_bwd(v, raw, t, gy, gld),
                    lambda: coupling_bwd_ref(v, raw, t, gy, gld),
                    ck.coupling_bwd(v, raw, t, gy, gld), coupling_bwd_ref(v, raw, t, gy, gld),
                    path="tile", call="RealNVP coupled backward")
            else:
                add(kernel, kernel, shape, lambda: ck.coupling_inv(v, raw, t),
                    lambda: coupling_inv_ref(v, raw, t), (ck.coupling_inv(v, raw, t),),
                    (coupling_inv_ref(v, raw, t),), path="tile",
                    call="calibration" if b == 4096 else "ragged last chunk")
    # the image priors at their largest scale: training batch 8, sampling 128
    for shape, what in (((8, 64, 12), "train"), ((128, 64, 12), "sample")):
        x_, ls, ab, w, raw, t = step_inputs(shape, f32, dev, SEED + 91)
        xr, hr = row_inputs(shape, f32, dev, SEED + 92)
        if what == "train":
            add("flowstep_fwd", "flowstep_fwd", shape,
                lambda: kern.flowstep_fwd(x_, ls, ab, w, raw, t),
                lambda: flowstep_fwd_ref(x_, ls, ab, w, raw, t),
                kern.flowstep_fwd(x_, ls, ab, w, raw, t), flowstep_fwd_ref(x_, ls, ab, w, raw, t),
                path=kern.flowstep_path(x_, raw, t), call="images-prior-scanned train step")
            add("coupling_fwd", "coupling_fwd_rows", shape, lambda: ck.coupling_fwd.rows(xr, hr),
                lambda: coupling_fwd_rows_ref(xr, hr), ck.coupling_fwd.rows(xr, hr)[:1],
                coupling_fwd_rows_ref(xr, hr)[:1],
                path=ck.coupling_path(xr, hr[..., :6], hr[..., 6:]),
                call="images-prior-coupled train step")
        else:
            w_inv = torch.linalg.inv(w)
            add("flowstep_inv", "flowstep_inv", shape,
                lambda: kern.flowstep_inv(x_, ls, ab, w_inv, raw, t),
                lambda: flowstep_inv_ref(x_, ls, ab, w_inv, raw, t),
                (kern.flowstep_inv(x_, ls, ab, w_inv, raw, t),),
                (flowstep_inv_ref(x_, ls, ab, w_inv, raw, t),),
                path=kern.flowstep_path(x_, raw, t), call="images-prior-scanned sample chunk")
            add("coupling_inv", "coupling_inv_rows", shape, lambda: ck.coupling_inv.rows(xr, hr),
                lambda: coupling_inv_rows_ref(xr, hr), (ck.coupling_inv.rows(xr, hr),),
                (coupling_inv_rows_ref(xr, hr),),
                path=ck.coupling_path(xr, hr[..., :6], hr[..., 6:]),
                call="images-prior-coupled sample chunk")
    return times


def uq_phase(dev, card, seismic) -> dict:
    """Phase 5c: the zoo and the UQ layer on the card, (a) to (d) above, then
    the kernels at the new paths' shapes; ``seismic``: phase 5d's trained
    ``seismic-uq`` run."""
    import shutil
    import tempfile

    out: dict = {"launches": {}}
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_uq_"))
    try:
        for part, run in (("realnvp", lambda: uq_realnvp(dev, card, out)),
                          ("hyperbolic", lambda: uq_hyperbolic(dev, card)),
                          ("seismic", lambda: uq_seismic(dev, card, out, seismic)),
                          ("priors", lambda: uq_priors(dev, card, scratch, out)),
                          ("launchers", lambda: uq_launchers(card, scratch)),
                          ("times", lambda: out.update(times=uq_times(dev, card)))):
            t0 = time.perf_counter()
            run()
            line("seconds-part", of=f"uq: {part}", seconds=round(time.perf_counter() - t0, 3))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return out


def float64_oracle(dev, x_cpu, grads, grads_cpu) -> dict:
    """How far the unrolled model's f32 gradients sit from the truth: each
    leaf against plain autograd of the same model in float64 on the CPU, for
    the card's and the CPU's ``coupled`` gradients, and for the card's with
    the reference's two-solve ``W^-1`` in every 1x1-conv reconstruction in
    place of ``lu_weight_inv``; with ``max |W W^-1 - I|`` of both inverses
    over the model's 24 1x1 convs.  Reported, not gated."""
    import torch
    from repro_torch.core import conv1x1 as c1
    from repro_torch.core import value_and_grad_nll

    _, g64 = value_and_grad_nll(build_coupled("cpu", grad_mode="autodiff").double(),
                                x_cpu.double())
    newton = c1.lu_weight_inv
    c1.lu_weight_inv = c1.lu_weight_inv_solves
    try:
        _, g_solves = value_and_grad_nll(build_coupled(dev), x_cpu.to(dev))
    finally:
        c1.lu_weight_inv = newton
    resid = {"lu_weight_inv": 0.0, "two_solves": 0.0}
    for layer in build_coupled("cpu").modules():
        if isinstance(layer, c1.Conv1x1):
            lu = {k: v.detach() for k, v in layer._lu().items()}
            w = c1.lu_weight(lu).double()
            eye = torch.eye(w.shape[0], dtype=torch.float64)
            for name, fn in (("lu_weight_inv", c1.lu_weight_inv), ("two_solves", c1.lu_weight_inv_solves)):
                resid[name] = max(resid[name], (w @ fn(lu).double() - eye).abs().max().item())
    return {"grad_max_rel_err_vs_float64": max_rel_leaf_err(grads, g64),
            "cpu_grad_max_rel_err_vs_float64": max_rel_leaf_err(grads_cpu, g64),
            "two_solve_inverse_grad_max_rel_err_vs_float64": max_rel_leaf_err(g_solves, g64),
            "w_winv_residual": resid}


def conv1x1_op_phase(dev, card) -> dict:
    """Phase 6: ``invertible_conv1x1`` forward and backward at the unrolled
    model's three (B, M, C), the path of the two 1x1-conv kernels: two
    ``conv1x1_mm`` and one ``conv1x1_gw`` per width."""
    import torch
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.conv1x1.ops import invertible_conv1x1

    inputs = [conv1x1_inputs(shape, torch.float32, dev, SEED + 12) for shape in CONV1X1_SHAPES[:3]]
    reset(c1k.KERNELS)
    for x, gy, w in inputs:
        x_, w_ = x.requires_grad_(), w.requires_grad_()
        gx, gw = torch.autograd.grad((invertible_conv1x1(x_, w_) * gy).sum(), (x_, w_))
        check(torch.isfinite(gx).all().item() and torch.isfinite(gw).all().item(),
              "invertible_conv1x1 gradient not finite")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in c1k.KERNELS}
    check(launches == {"conv1x1_mm": 6, "conv1x1_gw": 3}, f"invertible_conv1x1 launches: {launches}")
    line("op", op="invertible_conv1x1", shapes=[list(s) for s in CONV1X1_SHAPES[:3]],
         launches=launches, card=card)
    return launches


def attention_inputs(shape, dtype, dev, seed):
    """q (B, Hq, S, D) and k, v (B, Hkv, S, D), standard normal."""
    import torch

    b, hq, hkv, s, d = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g).to(dev, dtype) for h in (hq, hkv, hkv))


def check_attention_kernel(dev) -> dict:
    """Phase 2, ``flash_attention`` against ``attention_ref`` at
    ``ATTN_SHAPES``, f32 and bf16, causal or not: within the reference's
    ``_tol`` and bitwise repeatable, each on the path ``flash_path`` picks
    (bf16 with D % 16 == 0 on the tensor-core kernel, f32 with D % 8 == 0
    on the TF32 kernel, the rest on the CUDA-core one; each line names the
    path that ran).  Then (B, S, H, D)
    views passed as (B, H, S, D) in bf16, as ``attn_apply`` passes them,
    equal to the same call on copies; and a bf16 view TMA cannot take, on
    the CUDA-core kernel against ``attention_ref``.  Returns the largest abs
    error at each (shape, dtype)."""
    import torch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.attention.ref import attention_ref

    errs = {}
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            q, k, v = attention_inputs(shape, dtype, dev, SEED + 15)
            want = ak.flash_path(q, k, v)
            check(want == ("tensor_core" if dtype == torch.bfloat16 and shape[-1] % 16 == 0
                           else "tf32" if dtype == torch.float32 and shape[-1] % 8 == 0
                           else "cuda_core"), f"flash_path {shape} {dname}: {want}")
            for causal in (True, False):
                before = dict(ak.flash_attention.launches_by_path)
                o, o_again = ak.flash_attention(q, k, v, causal), ak.flash_attention(q, k, v, causal)
                r = attention_ref(q, k, v, causal).float()
                torch.cuda.synchronize()
                ran = [p for p, n in ak.flash_attention.launches_by_path.items() if n != before[p]]
                d = (o.float() - r).abs()
                tol = TOL_ATTN[dname]
                bad = int((d > tol + tol * r.abs()).sum().item())
                err = d.max().item()
                del r, d
                errs[(shape, dname)] = max(errs.get((shape, dname), 0.0), err)
                check(ran == [want], f"flash_attention {shape} {dname} ran {ran}")
                check(bad == 0, f"flash_attention {shape} {dname} causal={causal}: {bad} entries "
                                f"off, max {err}")
                check(torch.equal(o, o_again), f"flash_attention not bitwise repeatable at {shape}")
                line("kernels", kernel="flash_attention", shape=list(shape), dtype=dname,
                     causal=causal, path=ran[0], max_abs_err=err, tol=tol, bitwise_repeatable=True)
            del q, k, v
    g = torch.Generator(dev).manual_seed(SEED + 18)
    q, k, v = (torch.randn(2, 256, h, 64, generator=g, device=dev, dtype=torch.bfloat16)
               for h in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    o = ak.flash_attention(*views)
    o_copies = ak.flash_attention(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    check(torch.equal(o, o_copies) and o.transpose(1, 2).is_contiguous(),
          "flash_attention bf16 on strided heads differs from copies or changed layout")
    # q 8 bytes off a 16-byte boundary: TMA cannot copy it, so the CUDA-core
    # kernel takes the call
    misaligned = torch.empty(q.numel() + 4, device=dev, dtype=torch.bfloat16)[4:].view(views[0].shape)
    misaligned.copy_(views[0])
    before = dict(ak.flash_attention.launches_by_path)
    o = ak.flash_attention(misaligned, views[1], views[2])
    r = attention_ref(misaligned, views[1], views[2]).float()
    torch.cuda.synchronize()
    ran = [p for p, n in ak.flash_attention.launches_by_path.items() if n != before[p]]
    tol = TOL_ATTN["bfloat16"]
    err = (o.float() - r).abs().max().item()
    check(ran == ["cuda_core"], f"flash_attention on a misaligned bf16 q ran {ran}")
    check(bool(((o.float() - r).abs() <= tol + tol * r.abs()).all()),
          f"flash_attention on a misaligned bf16 q: max {err}")
    line("kernels", kernel="flash_attention", dtype="bfloat16", strided_heads_equal_copies=True,
         output_layout_kept=True, misaligned_view_path=ran[0], misaligned_view_max_abs_err=err)
    torch.cuda.empty_cache()
    return errs


def check_kernel_guards(dev) -> None:
    """Phase 2, the LM kernels' gradient guard: through ``flash_sdpa``,
    ``rwkv6_wkv`` and ``mamba2_ssd`` on the card, an input that requires grad
    raises on ``.backward()``; under ``no_grad`` the output and the launches
    equal those of the kernel called without the guard."""
    import torch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.attention.ops import flash_sdpa
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.rwkv.ops import rwkv6_wkv
    from repro_torch.kernels.ssd import ssd as sk
    from repro_torch.kernels.ssd.ops import mamba2_ssd

    q, k, v = attention_inputs(ATTN_SHAPES[1], torch.bfloat16, dev, SEED + 19)
    r, kw, vw, w, u, s0 = wkv_inputs(WKV_SHAPES[1], torch.float32, dev, SEED + 20)
    x, da, dt, b_in, c_in, s1 = ssd_inputs(SSD_SHAPES[1], torch.float32, dev, SEED + 21)
    chunk = SSD_SHAPES[1][-1]
    # kernel: (the op's call, through the guard; the kernel's own call; inputs)
    cases = {
        ak.flash_attention: (flash_sdpa, ak.flash_attention, (q, k, v)),
        rk.wkv_scan: (lambda *a: rwkv6_wkv(*a[:5], state0=a[5]),
                      lambda *a: rk.wkv_scan(*a[:5], state0=a[5]), (r, kw, vw, w, u, s0)),
        sk.ssd_scan: (lambda *a: mamba2_ssd(*a[:5], chunk=chunk, state0=a[5]),
                      lambda *a: sk.ssd_scan(*a[:5], chunk=chunk, state0=a[5]),
                      (x, da, dt, b_in, c_in, s1)),
    }
    out = {}
    for kernel, (op, unguarded, args) in cases.items():
        name = kernel.name
        y = op(args[0].clone().requires_grad_(), *args[1:])
        try:
            (y[0] if isinstance(y, tuple) else y).float().sum().backward()
            raised = ""
        except NotImplementedError as e:
            raised = str(e)
        check(name in raised, f"{name}: backward through the guarded kernel did not raise")
        n0 = kernel.launches
        with torch.no_grad():
            guarded = op(*args)
        n1 = kernel.launches
        plain = unguarded(*args)
        n2 = kernel.launches
        torch.cuda.synchronize()
        pairs = zip(guarded, plain) if isinstance(plain, tuple) else [(guarded, plain)]
        same = all(torch.equal(a, b) for a, b in pairs)
        check(same and n1 - n0 == n2 - n1 == 1,
              f"{name}: the guard changed the output or the launches ({n1 - n0} vs {n2 - n1})")
        out[name] = {"backward_raises": True, "no_grad_output_equal": True,
                     "launches_guarded_vs_unguarded": [n1 - n0, n2 - n1]}
    line("kernels", guards=out)


def attention_op_phase(dev, card) -> dict:
    """Phase 8, ``[op]``: ``attn_apply(impl="flash")`` against
    ``impl="xla"`` at yi-6b's width, batch 8 x 2048.  f32: within
    ``TOL_ATTN_OP``.  bf16: both paths against the f32 op on the same
    (bf16-rounded) inputs; the flash path, whose scores stay f32, may err no
    more than the einsum path, which rounds them to bf16 (mean absolute
    error; the maximum is reported).  One ``flash_attention`` launch a call;
    the einsum path launches none."""
    import torch
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.nn.attention import attn_apply, attn_init

    acfg = CONFIG.attention
    params = attn_init(torch.Generator(dev).manual_seed(SEED + 16), CONFIG.d_model, acfg)
    x = torch.randn(LM_BATCH, LM_PROMPT, CONFIG.d_model, generator=torch.Generator(dev).manual_seed(
        SEED + 17), device=dev)
    pos = torch.arange(LM_PROMPT, device=dev)
    reset(ak.KERNELS)
    out_flash, _ = attn_apply(params, x, acfg, pos, impl="flash")
    torch.cuda.synchronize()
    launches = ak.flash_attention.launches
    f32_by_path = dict(ak.flash_attention.launches_by_path)
    check(launches == 1 and f32_by_path["tf32"] == 1,
          f"attn_apply(impl='flash') in f32 launched {f32_by_path}")
    reset(ak.KERNELS)
    out_xla, _ = attn_apply(params, x, acfg, pos, impl="xla")
    torch.cuda.synchronize()
    check(ak.flash_attention.launches == 0, "attn_apply(impl='xla') launched the kernel")
    f32_err = (out_flash - out_xla).abs().max().item()
    bad = int(((out_flash - out_xla).abs() > TOL_ATTN_OP + TOL_ATTN_OP * out_xla.abs()).sum().item())
    check(bad == 0, f"attn_apply flash vs xla f32: {bad} entries off, max {f32_err}")
    del out_flash, out_xla

    xb = x.to(torch.bfloat16)
    exact, _ = attn_apply(params, xb.float(), acfg, pos, impl="xla")
    errs = {}
    by_path = dict(ak.flash_attention.launches_by_path)
    for impl in ("flash", "xla"):
        out, _ = attn_apply(params, xb, acfg, pos, impl=impl)
        d = (out.float() - exact).abs()
        errs[impl] = {"mean_abs_err": d.mean().item(), "max_abs_err": d.max().item()}
        del out, d
    by_path = {p: n - by_path[p] for p, n in ak.flash_attention.launches_by_path.items()}
    check(by_path == {"tensor_core": 1, "tf32": 0, "cuda_core": 0},
          f"attn_apply(impl='flash') in bf16 launched {by_path}")
    check(errs["flash"]["mean_abs_err"] <= errs["xla"]["mean_abs_err"],
          f"attn_apply bf16: flash path errs more than the einsum path: {errs}")
    line("op", op="attn_apply", impl="flash", d_model=CONFIG.d_model, batch=LM_BATCH,
         seq=LM_PROMPT, heads=[acfg.n_heads, acfg.n_kv_heads, acfg.head_dim],
         f32_flash_vs_xla_max_abs_err=f32_err, bf16_vs_f32_op=errs,
         launches_per_call=launches, f32_launches_by_path=f32_by_path,
         bf16_launches_by_path=by_path, card=card)
    del exact, x, params
    torch.cuda.empty_cache()
    return {"flash_attention": launches}


def lm_serve_phase(dev, card) -> dict:
    """Phase 8, ``[serve]`` yi-6b: (a) full width, depth 2, f32, the card
    against the CPU with the same weights; (b) full width and depth, bf16
    activations, weights drawn on the card, batch 8, a 2048-token prompt, 32
    new tokens.  Returns the served model, engine and prompt."""
    import torch
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    # (a) depth 2, f32: the card against the CPU
    cfg2 = CONFIG.replace(n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model_card = Model(cfg2, generator=torch.Generator(dev).manual_seed(SEED + 18), device=dev)
    model_cpu = copy.deepcopy(model_card).cpu()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, CONFIG.vocab_size, (LM_CPU_BATCH, LM_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(SEED + 19))
    max_len = LM_CPU_PROMPT + LM_CPU_NEW
    logits, _ = model_card.prefill({"tokens": tokens.to(dev)}, model_card.make_caches(LM_CPU_BATCH, max_len))
    t0 = time.perf_counter()
    logits_cpu, _ = model_cpu.prefill({"tokens": tokens}, model_cpu.make_caches(LM_CPU_BATCH, max_len))
    tok_cpu, _ = ServeEngine(model_cpu, max_len, device="cpu").generate({"tokens": tokens}, LM_CPU_NEW)
    cpu_s = time.perf_counter() - t0
    tok, _ = ServeEngine(model_card, max_len, device=dev).generate({"tokens": tokens}, LM_CPU_NEW)
    rel = (logits.cpu() - logits_cpu).abs().max().item() / logits_cpu.abs().max().item()
    check(torch.isfinite(logits).all().item() and rel <= TOL_LM_LOGITS,
          f"yi-6b depth-2 f32 prefill logits vs cpu: {rel} of the largest")
    check(torch.equal(tok.cpu(), tok_cpu), f"yi-6b depth-2 greedy tokens differ: {tok} vs {tok_cpu}")
    line("serve", model="yi-6b", depth=2, dtype="float32", batch=LM_CPU_BATCH, prompt=LM_CPU_PROMPT,
         new_tokens=LM_CPU_NEW, prefill_logits_rel_err_vs_cpu=rel, greedy_tokens_equal=True,
         init_and_copy_to_cpu_s=init_s, cpu_reference_s=cpu_s, card=card)
    del model_cpu, model_card, logits
    torch.cuda.empty_cache()

    # (b) full depth, bf16 activations, weights drawn on the card
    t0 = time.perf_counter()
    model = Model(CONFIG, generator=torch.Generator(dev).manual_seed(SEED + 20), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, LM_PROMPT + LM_NEW, device=dev)
    prompt = torch.randint(0, CONFIG.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator(dev).manual_seed(SEED + 21), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset(ak.KERNELS)
    t0 = time.perf_counter()
    out, last = engine.generate({"tokens": prompt}, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = ak.flash_attention.launches
    check(out.shape == (LM_BATCH, LM_NEW) and torch.isfinite(last).all().item(),
          f"yi-6b generate: tokens {tuple(out.shape)}, logits finite {torch.isfinite(last).all().item()}")
    check(int(out.min()) >= 0 and int(out.max()) < CONFIG.vocab_size, "yi-6b tokens outside the vocabulary")
    line("serve", model="yi-6b", depth=CONFIG.n_layers, dtype=CONFIG.dtype, batch=LM_BATCH,
         prompt=LM_PROMPT, new_tokens=LM_NEW, n_params=sum(p.numel() for p in model.parameters()),
         init_on_card_s=init_s, generate_s=gen_s, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         flash_attention_launches_per_generate=launches,
         why_zero="the reference's attention unit never passes impl='flash' (models/blocks.py:106-115)",
         first_tokens=out[:, :4].tolist(), distinct_tokens=int(out.unique().numel()), card=card)
    return {"model": model, "engine": engine, "prompt": prompt}


def lm_times(served, card, wall_ms, name: str = "yi-6b") -> None:
    """Phases 8 and 9, ``[times]``/``[profile]``: prefill (batch 8 x 2048)
    and one decode step of the served LM ``name``, medians and quartiles,
    tokens/s, one profiled call of each with the device's idle share and its
    top ops."""
    model, prompt = served["model"], served["prompt"]
    # a model with a front end: its whole prompt (features too), its
    # positions before the first new token, the encoder output for decode
    batch, pos = served.get("batch", {"tokens": prompt}), served.get("pos", LM_PROMPT)
    caches = model.make_caches(prompt.shape[0], pos + LM_NEW)
    tok = prompt[:, -1:]
    extra = served.get("extra")
    # prefill over 3 calls (5 until the examples needed the time)
    calls = {"prefill": (lambda: model.prefill(batch, caches), 3,
                         served.get("positions", prompt.numel())),
             "decode_step": (lambda: model.decode_step(tok, caches, pos, extra), 20,
                             prompt.shape[0])}
    for what, (fn, reps, n_tokens) in calls.items():
        median, runs_ms = wall_ms(fn, reps)
        q = sorted(runs_ms)
        line("times", model=name, e2e=what, batch=LM_BATCH, median_ms=median, q1_ms=q[len(q) // 4],
             q3_ms=q[(3 * len(q)) // 4], runs_ms=runs_ms, tokens_per_s=n_tokens / (median * 1e-3),
             card=card)
        busy_ms, idle, events = profile_call(fn, median, f"{name.replace('-', '')}_{what}")
        by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                        if not _is_device_event(e) and e.self_device_time_total > 0),
                       key=lambda r: -r[1])
        line("profile", model=name, call=what, device_busy_ms=busy_ms, unprofiled_median_ms=median,
             device_idle_share=idle, device_ms_by_op=[[k, round(v, 4), n] for k, v, n in by_op[:12]])


def time_attention(dev) -> list:
    """``[times]`` of ``flash_attention`` (causal, as prefill runs it) at
    yi-6b's prefill shape and the reference's (2, 8, 2, 256, 64), bf16 then
    f32; the library call is ``F.scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)``, timed only (top-left causal, as the
    kernel's when Sq == Skv).  f32 on the TF32 kernel is bounded at the TF32
    rate (its operations counted once); its line also gives the bound at
    the card's f32 rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.attention.ref import attention_ref

    rows = []
    for shape in (ATTN_SHAPES[3], ATTN_SHAPES[1]):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(shape, dtype, dev, SEED + 22)
            nbytes, flops = cost("flash_attention", shape, dtype)
            rows.append(time_kernel(
                "flash_attention", shape, dtype, lambda: ak.flash_attention(q, k, v),
                lambda: attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                path=ak.flash_path(q, k, v),
                f32_rate_bound_ms=max(1e3 * nbytes / H100_BYTES_PER_S,
                                      1e3 * flops / H100_F32_FLOPS)))
            del q, k, v
    torch.cuda.empty_cache()
    return rows


def wkv_inputs(shape, dtype, dev, seed, model_like=False):
    """r, k, v, w (B, H, S, K) in ``dtype``, each a (B, S, H, K) tensor viewed
    as (B, H, S, K), as the model passes them; u (H, K) and state0
    (B, H, K, K) in f32.  r, k, v standard normal; w = sigmoid(normal) as
    in the reference's kernel test, or with ``model_like`` rwkv6's decays,
    exp(-exp(-6 + normal)) (its init's w0 = -6, w ~ 0.9975)."""
    import torch

    b, h, s, kd = shape
    g = torch.Generator(dev).manual_seed(seed)
    r, k, v, z = (torch.randn(b, s, h, kd, generator=g, device=dev) for _ in range(4))
    w = torch.exp(-torch.exp(z - 6.0)) if model_like else torch.sigmoid(z)
    u = 0.1 * torch.randn(h, kd, generator=g, device=dev)
    state0 = 0.5 * torch.randn(b, h, kd, kd, generator=g, device=dev)
    return (*(t.to(dtype).transpose(1, 2) for t in (r, k, v, w)), u, state0)


def ssd_inputs(shape, dtype, dev, seed, model_like=False):
    """x (B, H, S, P) in ``dtype`` and da, dt (B, H, S) in f32, each viewed
    from a (B, S, H, .) tensor as the model passes them; b_in, c_in (B, S, N)
    in ``dtype``; state0 (B, H, P, N) in f32.  As in the reference's kernel
    test, dt = softplus(normal) and da = -dt exp(0.2 normal); with
    ``model_like`` zamba2's init, dt = softplus(normal + softplus^-1(0.01))
    and da = dt A with A = -linspace(1, 16, H)."""
    import torch
    import torch.nn.functional as F

    b, h, s, p, n, _ = shape
    g = torch.Generator(dev).manual_seed(seed)

    def rn(*sh):
        return torch.randn(sh, generator=g, device=dev)

    x = rn(b, s, h, p)
    if model_like:
        dt = F.softplus(rn(b, s, h) + math.log(math.expm1(0.01)))
        da = dt * -torch.linspace(1.0, 16.0, h, device=dev)
    else:
        dt = F.softplus(rn(b, s, h))
        da = -dt * torch.exp(0.2 * rn(b, s, h))
    b_in, c_in = rn(b, s, n).to(dtype), rn(b, s, n).to(dtype)
    state0 = 0.5 * rn(b, h, p, n)
    return x.to(dtype).transpose(1, 2), da.transpose(1, 2), dt.transpose(1, 2), b_in, c_in, state0


def check_scan_kernels(dev) -> dict:
    """Phase 2, ``wkv_scan`` and ``ssd_scan`` against ``wkv_ref`` and
    ``ssd_ref`` on the same inputs: at the reference's kernel-test shapes in
    f32 and bf16 within its 2e-4 / 5e-2, and at the model shapes in f32
    (rwkv6-7b's prefill and decode step, zamba2-7b's prefill; rwkv6's or
    zamba2's decays) within 1e-4 of the largest entry; with and
    without an initial state; a second call bitwise equal.  Returns each
    kernel's largest absolute y error at its model shape."""
    import torch
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.rwkv.ref import wkv_ref
    from repro_torch.kernels.ssd import ssd as sk
    from repro_torch.kernels.ssd.ref import ssd_ref

    def wkv(shape, dtype, state):
        r, k, v, w, u, s0 = wkv_inputs(shape, dtype, dev, SEED + 23,
                                       model_like=shape in (WKV_SHAPES[-1], WKV_DECODE_SHAPE))
        s0 = s0 if state else None
        return (lambda: rk.wkv_scan(r, k, v, w, u, state0=s0)), (lambda: wkv_ref(r, k, v, w, u, s0))

    def ssd(shape, dtype, state):
        x, da, dt, b_in, c_in, s0 = ssd_inputs(shape, dtype, dev, SEED + 24,
                                               model_like=shape == SSD_SHAPES[-1])
        s0 = s0 if state else None
        return ((lambda: sk.ssd_scan(x, da, dt, b_in, c_in, chunk=shape[-1], state0=s0)),
                (lambda: ssd_ref(x, da, dt, b_in, c_in, s0)))

    errs = {}
    # the reference's shapes, then the models': rwkv6-7b's prefill and its
    # decode step (1,024 of the 1,056 launches of a generate), zamba2-7b's
    # prefill
    for name, shapes, model_shapes, make in (
            ("wkv_scan", WKV_SHAPES + [WKV_DECODE_SHAPE], (WKV_SHAPES[-1], WKV_DECODE_SHAPE), wkv),
            ("ssd_scan", SSD_SHAPES, (SSD_SHAPES[-1],), ssd)):
        for shape in shapes:
            model = shape in model_shapes
            for dtype in (torch.float32,) if model else (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                for state in (False, True):
                    k_fn, p_fn = make(shape, dtype, state)
                    (y, st), (y2, st2) = k_fn(), k_fn()
                    y_r, st_r = p_fn()
                    torch.cuda.synchronize()
                    check(torch.equal(y, y2) and torch.equal(st, st2),
                          f"{name} not bitwise repeatable at {shape} {dname}")
                    out = {}
                    for what, a, r in (("y", y, y_r), ("state", st, st_r)):
                        d = (a.float() - r.float()).abs()
                        scale = r.float().abs().max().item()
                        out[what] = {"max_abs_err": d.max().item(), "scale": scale}
                        if model:
                            rel = d.max().item() / scale
                            check(rel <= TOL_SCAN_SCALE,
                                  f"{name} {what} {shape} state0={state}: {rel} of its scale")
                        else:
                            tol = TOL_SCAN[dname]
                            bad = int((d > tol + tol * r.float().abs()).sum().item())
                            check(bad == 0, f"{name} {what} {shape} {dname} state0={state}: {bad} "
                                            f"entries off, max {d.max().item()}")
                    if model:
                        errs[name] = max(errs.get(name, 0.0), out["y"]["max_abs_err"])
                    line("kernels", kernel=name, shape=list(shape), dtype=dname, state0=state,
                         **{f"{w}_{k}": v for w, o in out.items() for k, v in o.items()},
                         tol=TOL_SCAN_SCALE if model else TOL_SCAN[dname],
                         tol_of="scale" if model else "rtol=atol", bitwise_repeatable=True)
                    del y, y2, y_r, st, st2, st_r, k_fn, p_fn
        torch.cuda.empty_cache()
    return errs


def time_scans(dev) -> dict:
    """``[times]`` of ``wkv_scan`` at rwkv6-7b's prefill and decode step and
    of ``ssd_scan`` at zamba2-7b's prefill, f32 with an initial state, as the
    models call them; the plain versions (Python loops over 2,048 steps)
    over one call (two until the examples needed the time).  The decode
    step cycles through one input set and
    state per layer (32, 268 MB of states), so that each call reads its
    state cold from HBM as a decode step does, not from the 50 MB L2.  No
    single PyTorch call computes either function."""
    import torch
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.rwkv.ref import wkv_ref
    from repro_torch.kernels.ssd import ssd as sk
    from repro_torch.kernels.ssd.ref import ssd_ref

    def cycling(fn, sets):
        calls = itertools.cycle(sets)
        return lambda: fn(*next(calls))

    rows = {"wkv_scan": []}
    r, k, v, w, u, s0 = wkv_inputs(WKV_SHAPES[-1], torch.float32, dev, SEED + 25, model_like=True)
    rows["wkv_scan"].append(time_kernel(
        "wkv_scan", WKV_SHAPES[-1], torch.float32, lambda: rk.wkv_scan(r, k, v, w, u, state0=s0),
        lambda: wkv_ref(r, k, v, w, u, s0), plain_reps=1, kernels_per_call=1))
    del r, k, v, w, u, s0
    layers = [wkv_inputs(WKV_DECODE_SHAPE, torch.float32, dev, SEED + 60 + i, model_like=True)
              for i in range(WKV_DECODE_LAYERS)]
    rows["wkv_scan"].append(time_kernel(
        "wkv_scan", WKV_DECODE_SHAPE, torch.float32,
        cycling(lambda r, k, v, w, u, s0: rk.wkv_scan(r, k, v, w, u, state0=s0), layers),
        cycling(wkv_ref, layers), kernels_per_call=1))
    del layers
    shape = SSD_SHAPES[-1]
    x, da, dt, b_in, c_in, s0 = ssd_inputs(shape, torch.float32, dev, SEED + 26, model_like=True)
    _, flops = cost("ssd_scan", shape, torch.float32)
    rows["ssd_scan"] = [time_kernel(
        "ssd_scan", shape, torch.float32,
        lambda: sk.ssd_scan(x, da, dt, b_in, c_in, chunk=shape[-1], state0=s0),
        lambda: ssd_ref(x, da, dt, b_in, c_in, s0), plain_reps=1,
        kernels_per_call=sk.KERNELS_PER_CALL,
        bound_ms_at_f32_cuda_cores=1e3 * flops / H100_F32_FLOPS)]
    del x, da, dt, b_in, c_in
    torch.cuda.empty_cache()
    return rows


def ssm_serve_phase(dev, card, arch: str) -> dict:
    """Phase 9, ``[serve]`` rwkv6-7b or zamba2-7b: (a) full width at depth
    ``SSM_CPU_DEPTH[arch]``, f32, the card against the CPU with the same
    weights (prefill logits, 8 greedy tokens); (b) full width and depth,
    bf16 activations, f32 weights drawn on the card, batch 8, a 2048-token
    prompt, 32 new tokens, with the scan kernels' launches per ``generate``,
    per prefill and per decode step.  Returns the served model, its prompt
    and the main path's launches."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.ssd import ssd as sk
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    config = get_arch(arch).config
    kernels = (*rk.KERNELS, *sk.KERNELS)
    n_main = config.n_layers
    if config.family == "hybrid":  # the Mamba2 blocks of the main stack and the tail
        per = {"prefill": {"wkv_scan": 0, "ssd_scan": n_main},
               "decode_step": {"wkv_scan": 0, "ssd_scan": 0}}
    else:
        per = {"prefill": {"wkv_scan": n_main, "ssd_scan": 0},
               "decode_step": {"wkv_scan": n_main, "ssd_scan": 0}}
    seed = SEED + (40 if arch == "rwkv6-7b" else 50)

    # (a) cut depth, f32: the card against the CPU
    depth = SSM_CPU_DEPTH[arch]
    cfg_a = config.replace(n_layers=depth, dtype="float32")
    t0 = time.perf_counter()
    model_card = Model(cfg_a, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    model_cpu = copy.deepcopy(model_card).cpu()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, config.vocab_size, (LM_CPU_BATCH, LM_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1))
    max_len = LM_CPU_PROMPT + LM_CPU_NEW
    reset(kernels)
    logits, _ = model_card.prefill({"tokens": tokens.to(dev)},
                                   model_card.make_caches(LM_CPU_BATCH, max_len))
    torch.cuda.synchronize()
    a_launches = {k.name: k.launches for k in kernels}
    scan = "ssd_scan" if config.family == "hybrid" else "wkv_scan"
    check(a_launches[scan] == depth, f"{arch} depth-{depth} prefill launches: {a_launches}")
    t0 = time.perf_counter()
    logits_cpu, _ = model_cpu.prefill({"tokens": tokens}, model_cpu.make_caches(LM_CPU_BATCH, max_len))
    tok_cpu, _ = ServeEngine(model_cpu, max_len, device="cpu").generate({"tokens": tokens}, LM_CPU_NEW)
    cpu_s = time.perf_counter() - t0
    tok, _ = ServeEngine(model_card, max_len, device=dev).generate({"tokens": tokens}, LM_CPU_NEW)
    rel = (logits.cpu() - logits_cpu).abs().max().item() / logits_cpu.abs().max().item()
    check(torch.isfinite(logits).all().item() and rel <= TOL_LM_LOGITS,
          f"{arch} depth-{depth} f32 prefill logits vs cpu: {rel} of the largest")
    check(torch.equal(tok.cpu(), tok_cpu), f"{arch} depth-{depth} greedy tokens differ: {tok} vs {tok_cpu}")
    line("serve", model=arch, depth=depth, dtype="float32", batch=LM_CPU_BATCH, prompt=LM_CPU_PROMPT,
         new_tokens=LM_CPU_NEW, prefill_logits_rel_err_vs_cpu=rel, greedy_tokens_equal=True,
         launches_per_prefill=a_launches, init_and_copy_to_cpu_s=init_s, cpu_reference_s=cpu_s,
         card=card)
    del model_cpu, model_card, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full depth, bf16 activations, weights drawn on the card
    t0 = time.perf_counter()
    model = Model(config, generator=torch.Generator(dev).manual_seed(seed + 2), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, LM_PROMPT + LM_NEW, device=dev)
    prompt = torch.randint(0, config.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator(dev).manual_seed(seed + 3), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    out, last = engine.generate({"tokens": prompt}, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen_launches = {k.name: k.launches for k in kernels}
    expected = {k: per["prefill"][k] + LM_NEW * per["decode_step"][k] for k in per["prefill"]}
    check(gen_launches == expected, f"{arch} generate launches {gen_launches}, expected {expected}")
    check(out.shape == (LM_BATCH, LM_NEW) and torch.isfinite(last).all().item(),
          f"{arch} generate: tokens {tuple(out.shape)}, logits finite {torch.isfinite(last).all().item()}")
    check(int(out.min()) >= 0 and int(out.max()) < config.vocab_size, f"{arch} tokens outside the vocabulary")
    caches = model.make_caches(LM_BATCH, LM_PROMPT + LM_NEW)
    measured = {}
    for what, fn in (("prefill", lambda: model.prefill({"tokens": prompt}, caches)),
                     ("decode_step", lambda: model.decode_step(out[:, :1], caches, LM_PROMPT))):
        reset(kernels)
        fn()
        torch.cuda.synchronize()
        measured[what] = {k.name: k.launches for k in kernels}
    check(measured == per, f"{arch} launches per call {measured}, expected {per}")
    del caches
    line("serve", model=arch, depth=config.n_layers, dtype=config.dtype, batch=LM_BATCH,
         prompt=LM_PROMPT, new_tokens=LM_NEW, n_params=sum(p.numel() for p in model.parameters()),
         init_on_card_s=init_s, generate_s=gen_s, peak_memory_bytes=peak,
         launches_per_generate=gen_launches, launches_per_prefill=measured["prefill"],
         launches_per_decode_step=measured["decode_step"], first_tokens=out[:, :4].tolist(),
         distinct_tokens=int(out.unique().numel()), card=card)
    return {"model": model, "prompt": prompt, "launches": gen_launches[scan]}


# ---------------------------------------------------------------------------
# 10. the rest of the dense family and the MoE family served; 11. LM training
# ---------------------------------------------------------------------------

#: phase 10's models: (arch, the card-against-CPU model: "reduced" or a depth
#: at full width, the depth served on the card at full width or None, why)
LM_FAMILY = (
    ("glm4-9b", 2, 10, "depth 10 of 40 (12.9 GB of f32 weights; whole, 37.6 GB, fits the "
                       "card but not the script's time limit; 20 until phase 15)"),
    ("granite-34b", "reduced", 6, "depth 6 of 88: 11.5 GB of f32 weights (1.52 GB a layer), "
                                  "for the script's time limit (12 until phase 15)"),
    ("command-r-plus-104b", "reduced", 2,
     "depth 2 of 64: 25.2 GB of f32 weights (6.29 GB a layer, 12.58 GB the tied embedding; 4 "
     "until phase 15)"),
    ("granite-moe-1b-a400m", 2, 24, "full depth: 5.5 GB of f32 weights"),
    ("llama4-maverick-400b-a17b", "reduced", None,
     "REDUCED only: one superblock (two layers) holds about 66 GB of f32 weights; two ranks "
     "that share this one card hold the same bytes as one, model-sharded or not"),
)
LM_TRAIN_ARCH = "granite-moe-1b-a400m"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 2048, 4
#: (b)'s depth and steps, 4 of 24 layers and 4 steps: with the SSM parts of
#: phase 11, phases 12-14 the script must still end inside its time limit,
#: and (b)'s checkpoint writes take most of its time (all 24 layers: 16.6 GB
#: each; 12 layers took 11-14 s a write, 6 layers 7.2-8.6 s on a slow host)
LM_TRAIN_DEPTH = 4
LM_CMP_BATCH, LM_CMP_SEQ = 2, 256     # (a): full width, depth 2, f32
LM_MEM_BATCH, LM_MEM_DEPTHS = 2, (2, 4)  # (c): full width, bf16 (2 / 6 until phase 14)


class RouteLog:
    """Record the expert indices of every ``moe.route`` call while active."""

    def __enter__(self):
        from repro_torch.nn import moe

        self.mod, self.orig, self.calls = moe, moe.route, []

        def route(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append(out[2].detach().cpu())
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def routing_flips(calls, n_moe: int, mode: str) -> int:
    """(token, k) expert choices that the backward's re-routing (from the
    rebuilt input) changed against the forward's, summed over its calls:
    ``invertible`` routes each layer twice (inverse, then the VJP), last
    layer first; ``coupled`` once; the others not at all."""
    fwd, bwd = calls[:n_moe], calls[n_moe:]
    order = {"invertible": [i for i in range(n_moe - 1, -1, -1) for _ in (0, 1)],
             "coupled": list(range(n_moe - 1, -1, -1))}.get(mode, [])
    return sum(int((b != fwd[i]).sum()) for b, i in zip(bwd, order))


def lm_arch_serve(dev, card, arch, cmp, depth, why, seed) -> dict | None:
    """Phase 10 for one architecture: (a) the card against the CPU in f32
    (prefill logits within ``TOL_LM_LOGITS`` of the largest, 8 greedy tokens
    equal) at ``cmp`` (``"reduced"`` or a depth at full width); (b) full
    width at ``depth`` on the card in bf16, batch 8, a 2048-token prompt, 32
    new tokens, 0 ``flash_attention`` launches a ``generate``.  Returns (b)'s
    served model, prompt and ``flash_attention`` launches, or None."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    spec = get_arch(arch)
    cfg_a = (spec.reduced if cmp == "reduced" else spec.config.replace(n_layers=cmp)).replace(
        dtype="float32")
    t0 = time.perf_counter()
    model_card = Model(cfg_a, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    model_cpu = copy.deepcopy(model_card).cpu()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg_a.vocab_size, (LM_CPU_BATCH, LM_CPU_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1))
    max_len = LM_CPU_PROMPT + LM_CPU_NEW
    with RouteLog() as r_card:
        logits, _ = model_card.prefill({"tokens": tokens.to(dev)},
                                       model_card.make_caches(LM_CPU_BATCH, max_len))
    t0 = time.perf_counter()
    with RouteLog() as r_cpu:
        logits_cpu, _ = model_cpu.prefill({"tokens": tokens},
                                          model_cpu.make_caches(LM_CPU_BATCH, max_len))
    tok_cpu, _ = ServeEngine(model_cpu, max_len, device="cpu").generate({"tokens": tokens},
                                                                         LM_CPU_NEW)
    cpu_s = time.perf_counter() - t0
    reset(ak.KERNELS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok, _ = ServeEngine(model_card, max_len, device=dev).generate({"tokens": tokens}, LM_CPU_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    flips = sum(int((a != b).sum()) for a, b in zip(r_card.calls, r_cpu.calls))
    rel = (logits.cpu() - logits_cpu).abs().max().item() / logits_cpu.abs().max().item()
    line("serve", model=arch, width="reduced" if cmp == "reduced" else "full",
         depth=cfg_a.n_layers, dtype="float32", batch=LM_CPU_BATCH, prompt=LM_CPU_PROMPT,
         new_tokens=LM_CPU_NEW, prefill_logits_rel_err_vs_cpu=rel,
         greedy_tokens_equal=bool(torch.equal(tok.cpu(), tok_cpu)),
         prefill_routing_flips_vs_cpu=flips, init_and_copy_to_cpu_s=init_s, cpu_reference_s=cpu_s,
         card_generate_s=gen_s,
         card_generate_tokens_per_s=LM_CPU_BATCH * (LM_CPU_PROMPT + LM_CPU_NEW) / gen_s,
         card_peak_memory_bytes=torch.cuda.max_memory_allocated(),
         flash_attention_launches_per_generate=ak.flash_attention.launches, card=card)
    check(ak.flash_attention.launches == 0, f"{arch} generate launched flash_attention")
    check(torch.isfinite(logits).all().item() and rel <= TOL_LM_LOGITS,
          f"{arch} {cfg_a.n_layers}-layer f32 prefill logits vs cpu: {rel} of the largest")
    check(torch.equal(tok.cpu(), tok_cpu), f"{arch} greedy tokens differ: {tok} vs {tok_cpu}")
    del model_cpu, model_card, logits
    gc.collect()
    torch.cuda.empty_cache()
    if depth is None:
        line("serve", model=arch, full_width_on_the_card=False, why=why, card=card)
        return None

    cfg = spec.config.replace(n_layers=depth)
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(seed + 2), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, LM_PROMPT + LM_NEW, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator(dev).manual_seed(seed + 3), device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset(ak.KERNELS)
    t0 = time.perf_counter()
    out, last = engine.generate({"tokens": prompt}, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = ak.flash_attention.launches
    check(out.shape == (LM_BATCH, LM_NEW) and torch.isfinite(last).all().item(),
          f"{arch} generate: tokens {tuple(out.shape)}, finite {torch.isfinite(last).all().item()}")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size, f"{arch} tokens outside vocab")
    check(launches == 0, f"{arch} generate launched flash_attention {launches} times")
    n_params = sum(p.numel() for p in model.parameters())
    line("serve", model=arch, depth=depth, of_depth=spec.config.n_layers, why_this_depth=why,
         dtype=cfg.dtype, batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW, n_params=n_params,
         f32_weight_bytes=4 * n_params, init_on_card_s=init_s, generate_s=gen_s,
         generate_tokens_per_s=LM_BATCH * (LM_PROMPT + LM_NEW) / gen_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         flash_attention_launches_per_generate=launches,
         first_tokens=out[:, :4].tolist(), distinct_tokens=int(out.unique().numel()), card=card)
    return {"model": model, "prompt": prompt, "launches": launches}


def lm_family_serve_phase(dev, card, wall_ms) -> dict:
    """Phase 10: ``LM_FAMILY`` one model at a time, each freed before the
    next; ``[times]``/``[profile]`` of each model served on the card.
    Returns the ``flash_attention`` launches a ``generate`` by model."""
    import torch

    launches = {}
    for i, (arch, cmp, depth, why) in enumerate(LM_FAMILY):
        served = lm_arch_serve(dev, card, arch, cmp, depth, why, SEED + 60 + 10 * i)
        if served is not None:
            launches[arch] = served.pop("launches")
            lm_times(served, card, wall_ms, name=arch)
        del served
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def lm_grads(model, batch, mode):
    """``(loss, {name: grad})`` of ``model.train_loss`` under ``mode``."""
    from repro_torch.train.loop import objective_value_and_grad

    return objective_value_and_grad(model, lambda b: model.train_loss(b, grad_mode=mode))(batch)


def lm_train_vs_cpu(dev, card) -> None:
    """(a) granite-moe at full width and depth 2 in f32, batch 2 x 256: loss
    and every gradient leaf on the card against the CPU under
    ``invertible``, ``coupled`` and ``autodiff`` (``TOL_LOSS_REL``,
    ``TOL_GRAD_REL``), each step twice on the card, bitwise; then in bf16
    on the card, ``invertible`` against ``autodiff``: every leaf within
    ``TOL_GRAD_REL`` unless the backward's re-routing flipped a routing
    decision (the flips are reported either way)."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import Model

    config = get_arch(LM_TRAIN_ARCH).config
    cfg = config.replace(n_layers=2, dtype="float32")
    model_cpu = Model(cfg, generator=torch.Generator().manual_seed(SEED + 70), device="cpu")
    model_card = copy.deepcopy(model_cpu).to(dev)
    batch = SyntheticTokens(cfg.vocab_size, LM_CMP_SEQ, LM_CMP_BATCH, seed=7).batch_at(0)
    batch_dev = {k: v.to(dev) for k, v in batch.items()}
    for mode in ("invertible", "coupled", "autodiff"):
        t0 = time.perf_counter()
        with RouteLog() as r_cpu:
            loss_cpu, g_cpu = lm_grads(model_cpu, batch, mode)
        cpu_s = time.perf_counter() - t0
        with RouteLog() as r_card:
            loss, grads = lm_grads(model_card, batch_dev, mode)
        loss2, grads2 = lm_grads(model_card, batch_dev, mode)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(loss, loss2)) and all(torch.equal(grads[k], grads2[k])
                                                         for k in grads)
        loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
        grad_rel, worst = max_rel_leaf_err(grads, g_cpu)
        flips = sum(int((a != b).sum()) for a, b in zip(r_card.calls[:2], r_cpu.calls[:2]))
        line("lm-train", part="a", model=LM_TRAIN_ARCH, depth=2, dtype="float32",
             batch=[LM_CMP_BATCH, LM_CMP_SEQ], grad_mode=mode, loss=loss.item(),
             loss_rel_err_vs_cpu=loss_rel, grad_max_rel_err_vs_cpu=grad_rel, worst_leaf=worst,
             bitwise_repeatable=repeat, forward_routing_flips_vs_cpu=flips,
             backward_routing_flips_card=routing_flips(r_card.calls, 2, mode), cpu_s=cpu_s,
             card=card)
        check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL,
              f"lm-train (a) {mode}: loss {loss.item()} vs cpu {loss_cpu.item()}")
        check(grad_rel <= TOL_GRAD_REL, f"lm-train (a) {mode}: leaf {worst} at {grad_rel}")
        check(repeat, f"lm-train (a) {mode}: two steps on the card differ")
    del model_cpu, model_card
    # bf16 activations on the card: invertible against autodiff, autodiff
    # rerun with the routing the invertible backward's VJPs chose, so that a
    # flipped choice compares like with like and every leaf is gated
    from repro_torch.nn.moe import pinned_routes

    model = Model(config.replace(n_layers=2), generator=torch.Generator(dev).manual_seed(SEED + 71),
                  device=dev)
    res = {}
    for mode in ("autodiff", "invertible"):
        with RouteLog() as r:
            res[mode] = lm_grads(model, batch_dev, mode) + (r.calls,)
    n_moe = 2
    calls = res["invertible"][2]
    # the backward routes each layer twice, last layer first: inverse, then VJP
    vjp_routes = [calls[n_moe + 2 * (n_moe - 1 - i) + 1] for i in range(n_moe)]
    with pinned_routes(vjp_routes):
        pinned = lm_grads(model, batch_dev, "autodiff")
    grad_rel, worst = max_rel_leaf_err(res["invertible"][1], pinned[1])
    free_rel, free_worst = max_rel_leaf_err(res["invertible"][1], res["autodiff"][1])
    flips = routing_flips(calls, n_moe, "invertible")
    n_choices = sum(c.numel() for c in calls[:n_moe])
    line("lm-train", part="a-bf16", model=LM_TRAIN_ARCH, depth=2, dtype=config.dtype,
         batch=[LM_CMP_BATCH, LM_CMP_SEQ], loss_invertible=res["invertible"][0].item(),
         loss_autodiff=res["autodiff"][0].item(), loss_autodiff_pinned=pinned[0].item(),
         grad_max_rel_err_invertible_vs_pinned_autodiff=grad_rel, worst_leaf=worst,
         grad_max_rel_err_invertible_vs_autodiff=free_rel, worst_leaf_unpinned=free_worst,
         backward_routing_flips=flips, routing_choices_per_pass=n_choices, card=card)
    check(abs(res["invertible"][0].item() - res["autodiff"][0].item())
          <= TOL_LOSS_REL * abs(res["autodiff"][0].item()),
          "lm-train (a-bf16): the invertible forward's loss differs from autodiff's")
    check(grad_rel <= TOL_GRAD_REL,
          f"lm-train (a-bf16): invertible vs autodiff on its routing: leaf {worst} at {grad_rel} "
          f"({flips} routing flips)")
    del model, res, pinned
    gc.collect()
    torch.cuda.empty_cache()


class StepClock:
    """A ``FailureInjector`` stand-in that fails nothing: at each step's
    start (and at ``finish``) it synchronises the card, reads the wall clock
    and the peak memory since the last mark (then resets it), and under a
    profiler opens a ``record_function`` range per step."""

    def __init__(self, profiled: bool):
        self.profiled, self.marks, self.peaks, self.range = profiled, [], [], None

    def _mark(self):
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        self.peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None

    def maybe_fail(self, step: int):
        import torch

        self._mark()
        if self.profiled:
            self.range = torch.profiler.record_function(f"lm_step_{step}")
            self.range.__enter__()

    def finish(self):
        self._mark()


def step_busy_ms(prof) -> dict[str, float]:
    """Device-busy ms of each ``lm_step_<k>`` range: the durations of the
    kernels that started inside it."""
    events = prof.events()
    # the ranges' own spans on the device timeline are no kernels
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("lm_step_") and not _is_device_event(e)}
    kernels = [(e.time_range.start, e.time_range.elapsed_us()) for e in events
               if _is_device_event(e) and not e.name.startswith("lm_step_")]
    return {name: sum(d for s, d in kernels if lo <= s < hi) / 1e3
            for name, (lo, hi) in ranges.items()}


def lm_train_full(dev, card) -> float:
    """(b) granite-moe at full width and depth ``LM_TRAIN_DEPTH``, bf16
    activations, f32 master weights, AdamW, ``SyntheticTokens`` 8 x 2048:
    ``LM_TRAIN_STEPS`` steps of ``train_lm`` under ``invertible`` (profiled:
    per step wall, busy, idle share, tokens/s, peak memory; checkpoints after
    the middle step and the last), then a restart from the middle checkpoint
    that reproduces the last step bit for bit.  Returns the
    ``flash_attention`` launches a step of the first run and each step's
    peak memory (``torch.cuda.max_memory_allocated`` over the step)."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.loop import train_lm

    cfg = get_arch(LM_TRAIN_ARCH).config.replace(n_layers=LM_TRAIN_DEPTH)
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 72), device=dev)
    data = SyntheticTokens(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=11)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    half = LM_TRAIN_STEPS // 2
    tcfg = TrainConfig(steps=LM_TRAIN_STEPS, lr=3e-4, warmup_steps=2, checkpoint_every=half,
                       checkpoint_dir=str(scratch), keep_checkpoints=2)
    saves = []
    real_save = ckpt_mod.save

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = real_save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    ckpt_mod.save = timed_save
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    try:
        clock = StepClock(profiled=True)
        reset(ak.KERNELS)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = train_lm(model, data, tcfg, grad_mode="invertible", device=dev, injector=clock)
            clock.finish()
        busy = step_busy_ms(prof)
        flash = ak.flash_attention.launches
        final = {k: v.clone() for k, v in model.state_dict().items()}
        walls = [1e3 * (b - a) for a, b in zip(clock.marks, clock.marks[1:])]
        save_ms = {half - 1: 1e3 * saves[0], LM_TRAIN_STEPS - 1: 1e3 * saves[1]}
        for step, (loss, window) in enumerate(zip(res.losses, walls)):
            # wall_ms leaves out a checkpoint's write; busy and idle are over
            # the whole window, the write's device-to-host copies included
            step_ms = window - save_ms.get(step, 0.0)
            b = busy.get(f"lm_step_{step}", 0.0)
            line("lm-train", part="b", model=LM_TRAIN_ARCH, depth=cfg.n_layers, step=step + 1,
                 loss=loss, wall_ms=step_ms, checkpoint_save_ms=save_ms.get(step),
                 window_ms=window, busy_ms=b, idle_share=max(0.0, 1 - b / window),
                 tokens_per_s=tokens / (step_ms * 1e-3), peak_memory_bytes=clock.peaks[step + 1],
                 profiled=True, card=card)
        check(len(res.losses) == LM_TRAIN_STEPS and all(math.isfinite(v) for v in res.losses),
              f"lm-train (b): losses {res.losses}")
        check(0 < res.losses[0] < 2 * math.log(cfg.vocab_size),
              f"lm-train (b): first loss {res.losses[0]} outside (0, 2 log V)")
        check(flash == 0, f"lm-train (b): {flash} flash_attention launches")
        # the restart: drop the final checkpoint, resume from the middle one
        shutil.rmtree(scratch / f"step_{LM_TRAIN_STEPS - 1:08d}")
        check(ckpt_mod.latest_step(str(scratch)) == half - 1,
              f"lm-train (b): no step-{half} checkpoint")
        clock2 = StepClock(profiled=False)
        t0 = time.perf_counter()
        res2 = train_lm(model, data, tcfg, grad_mode="invertible", device=dev, injector=clock2)
        clock2.finish()
        restart_s = time.perf_counter() - t0
        same = all(torch.equal(final[k], v) for k, v in model.state_dict().items())
        walls2 = [1e3 * (b - a) for a, b in zip(clock2.marks, clock2.marks[1:])]
        walls2[-1] -= 1e3 * saves[-1]  # the final checkpoint's write
        line("lm-train", part="b-restart", model=LM_TRAIN_ARCH, resumed_after_step=half,
             steps_run=len(res2.losses), losses=res2.losses, last_step_bitwise_equal=same,
             losses_bitwise_equal=res2.losses == res.losses[half:],
             unprofiled_wall_ms=walls2, checkpoint_save_s=saves,
             restart_s_with_restore_and_save=restart_s,
             n_params=sum(p.numel() for p in model.parameters()), card=card)
        check(same and res2.losses == res.losses[half:], "lm-train (b): the restart differs")
    finally:
        ckpt_mod.save = real_save
        shutil.rmtree(scratch, ignore_errors=True)
    del model, final
    gc.collect()
    torch.cuda.empty_cache()
    return flash / LM_TRAIN_STEPS, clock.peaks[1:]


def lm_train_memory(dev, card) -> None:
    """(c) peak memory of one train step (loss, gradient, AdamW) of
    granite-moe at full width, ``LM_MEM_DEPTHS``, batch 2 x 2048, bf16, under
    each engine: the peak above the bytes held when the step starts (the
    model and its AdamW state), whose growth with depth under
    ``invertible`` and ``coupled`` must each stay below a quarter of
    ``autodiff``'s (the quarter rule of ``[memory]``)."""
    import torch
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, adamw_update

    config = get_arch(LM_TRAIN_ARCH).config
    batch = {k: v.to(dev) for k, v in SyntheticTokens(
        config.vocab_size, LM_TRAIN_SEQ, LM_MEM_BATCH, seed=13).batch_at(0).items()}
    peaks, above = {}, {}
    for mode in ("invertible", "coupled", "remat", "autodiff"):
        for depth in LM_MEM_DEPTHS:
            model = Model(config.replace(n_layers=depth),
                          generator=torch.Generator(dev).manual_seed(SEED + 73), device=dev)
            params = dict(model.named_parameters())
            opt = adamw_init(params)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            _loss, grads = lm_grads(model, batch, mode)
            adamw_update(params, grads, opt, TrainConfig(), 1e-4)
            torch.cuda.synchronize()
            key = f"{mode}_depth{depth}"
            peaks[key] = torch.cuda.max_memory_allocated()
            above[key] = peaks[key] - start
            del model, params, opt, grads
            gc.collect()
            torch.cuda.empty_cache()
    lo, hi = LM_MEM_DEPTHS
    growth = {m: above[f"{m}_depth{hi}"] - above[f"{m}_depth{lo}"]
              for m in ("invertible", "coupled", "remat", "autodiff")}
    line("lm-train", part="c", model=LM_TRAIN_ARCH, batch=[LM_MEM_BATCH, LM_TRAIN_SEQ],
         dtype=config.dtype, peaks_bytes=peaks, above_step_start_bytes=above,
         growth_bytes={f"{m}_depth{lo}_to_{hi}": g for m, g in growth.items()},
         growth_vs_autodiff={m: g / growth["autodiff"] for m, g in growth.items()}, card=card)
    for mode in ("invertible", "coupled"):
        check(growth[mode] < 0.25 * growth["autodiff"],
              f"lm-train (c): {mode} grew {growth[mode]} B, autodiff {growth['autodiff']} B")


def lm_train_launcher(dev, card) -> None:
    """(d) ``repro_torch.launch.train --arch granite-moe-1b-a400m --reduced
    --steps 4`` as a subprocess, to exit 0."""
    import os
    import shutil
    import tempfile

    scratch = tempfile.mkdtemp(prefix="chip_smoke_lm_launch_")
    argv = ["repro_torch.launch.train", "--arch", LM_TRAIN_ARCH, "--reduced", "--steps", "4",
            "--ckpt", scratch]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    shutil.rmtree(scratch, ignore_errors=True)
    lines = proc.stdout.strip().splitlines()
    line("lm-train", part="d", argv=argv, returncode=proc.returncode,
         seconds=time.perf_counter() - t0, stdout=lines[-4:],
         stderr_tail=proc.stderr.strip().splitlines()[-5:] if proc.returncode else [], card=card)
    check(proc.returncode == 0 and lines, f"launcher {' '.join(argv)} exited {proc.returncode}")


# ---------------------------------------------------------------------------
# 11, continued: the SSM models trained through their plain scans
# ---------------------------------------------------------------------------

#: (arch, cut depth at full width, why): the smallest depth that holds a
#: whole superblock, for (a) and (b)
SSM_TRAIN = (
    ("rwkv6-7b", 1, "depth 1 of 32 (a superblock is one RWKV6 layer; 2 until phase 13 needed "
                    "the time); whole, weights, gradients and AdamW moments need "
                    "16 B x 7.52 B > 80 GB"),
    ("zamba2-7b", 7, "depth 7 of 81: one superblock (six Mamba2 blocks, the shared attention "
                     "and FFN) and a one-block tail; whole needs 16 B x 6.75 B > 80 GB"),
)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 512, 4   # (b), bf16
#: (b)'s depths: one superblock each, the least checkpoint to write twice and
#: read back (a checkpoint holds 12 B a parameter; the embedding and head are
#: most of rwkv6-7b's)
SSM_RESTART_DEPTH = {"rwkv6-7b": 1, "zamba2-7b": 6}
#: the models whose (b) run is repeated with checkpoints, failed and
#: restarted: zamba2-7b alone since phase 15 (its writes and read took 53.5 s
#: for rwkv6-7b, 58.6 s for zamba2-7b; the restart is the loop's, the same
#: code for both)
SSM_RESTART = ("zamba2-7b",)
#: (ssm-a) the gate on a leaf is the larger of TOL_GRAD_REL and this many
#: times the step's own f32 sensitivity: how far the card's gradient moves
#: when the embedding table moves by one f32 ulp (relative 2^-23, random
#: signs).  The card and the CPU sum every product in another order (up to
#: 14,336 terms, some tens of ulps a result) where the probe moves the input
#: alone by one; a wrong gradient moves leaves by O(1) of their scale.
SSM_NOISE_FACTOR = 8
#: (c): (arch, depths, batch, seq): the plain per-token wkv loop under
#: autograd saves about 3 (B, H, K, K) f32 states a token and layer
SSM_MEM = (("rwkv6-7b", (1, 2), 2, 1024), ("zamba2-7b", (6, 12), 2, 2048))


def scan_kernels():
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.ssd import ssd as sk

    return (*rk.KERNELS, *sk.KERNELS)


def one_ulp_sensitivity(model, batch, mode, grads, seed) -> tuple[float, str]:
    """``max_rel_leaf_err`` between ``grads`` and the gradients of the same
    step with ``model``'s embedding table scaled by ``1 + s 2^-23`` (s = +-1
    at random), the table restored after."""
    import torch

    saved = model.embed.detach().clone()
    gen = torch.Generator(saved.device).manual_seed(seed)
    sign = torch.randint(0, 2, saved.shape, generator=gen, device=saved.device) * 2 - 1
    with torch.no_grad():
        model.embed.mul_(1 + 2.0**-23 * sign)
    try:
        _loss, moved = lm_grads(model, batch, mode)
    finally:
        with torch.no_grad():
            model.embed.copy_(saved)
    return max_rel_leaf_err(moved, grads)


def ssm_train_vs_cpu(dev, card) -> None:
    """(ssm-a) rwkv6-7b at depth 1 and zamba2-7b at depth 7, full width, f32,
    batch 2 x 256: loss and every gradient leaf on the card against the CPU
    under ``invertible`` and ``autodiff``, each step twice on the card
    bitwise, with the scan kernels' launches per train step (0: training
    runs the plain scans).  The loss at ``TOL_LOSS_REL``; each leaf within
    the larger of ``TOL_GRAD_REL`` and ``SSM_NOISE_FACTOR`` times the step's
    one-ulp sensitivity (``one_ulp_sensitivity``, on the card): these
    models' gradients are ill-conditioned in f32 (RWKV6's per-head group
    norm at the first token, where the state is zero, sees variances far
    below its eps; the reversible rebuild of the small embedding under O(1)
    residual updates), so no two f32 evaluations agree to 1e-4 of a leaf's
    scale; the CPU's own ``invertible`` against ``autodiff`` is reported
    beside it."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import Model

    kernels = scan_kernels()
    for i, (arch, depth, why) in enumerate(SSM_TRAIN):
        cfg = get_arch(arch).config.replace(n_layers=depth, dtype="float32")
        model_card = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 80 + i),
                           device=dev)
        model_cpu = copy.deepcopy(model_card).cpu()
        batch = SyntheticTokens(cfg.vocab_size, LM_CMP_SEQ, LM_CMP_BATCH, seed=17).batch_at(0)
        batch_dev = {k: v.to(dev) for k, v in batch.items()}
        g_cpu = {}
        for mode in ("invertible", "autodiff"):
            t0 = time.perf_counter()
            loss_cpu, g_cpu[mode] = lm_grads(model_cpu, batch, mode)
            cpu_s = time.perf_counter() - t0
            reset(kernels)
            t0 = time.perf_counter()
            loss, grads = lm_grads(model_card, batch_dev, mode)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            loss2, grads2 = lm_grads(model_card, batch_dev, mode)
            torch.cuda.synchronize()
            launches = {k.name: k.launches / 2 for k in kernels}
            repeat = bool(torch.equal(loss, loss2)) and all(torch.equal(grads[k], grads2[k])
                                                             for k in grads)
            del grads2
            noise, noise_leaf = one_ulp_sensitivity(model_card, batch_dev, mode, grads, SEED + 82)
            gate = max(TOL_GRAD_REL, SSM_NOISE_FACTOR * noise)
            loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
            grad_rel, worst = max_rel_leaf_err(grads, g_cpu[mode])
            extra = {}
            if mode == "autodiff":
                extra["cpu_invertible_vs_autodiff"] = max_rel_leaf_err(g_cpu["invertible"],
                                                                       g_cpu["autodiff"])
            line("lm-train", part="ssm-a", model=arch, depth=depth, why_this_depth=why,
                 dtype="float32", batch=[LM_CMP_BATCH, LM_CMP_SEQ], grad_mode=mode,
                 loss=loss.item(), loss_rel_err_vs_cpu=loss_rel, grad_max_rel_err_vs_cpu=grad_rel,
                 worst_leaf=worst, one_ulp_sensitivity=noise, sensitivity_leaf=noise_leaf,
                 leaf_gate=gate, bitwise_repeatable=repeat, scan_launches_per_step=launches,
                 card_step_s=card_s, cpu_s=cpu_s, **extra, card=card)
            check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL,
                  f"lm-train (ssm-a) {arch} {mode}: loss {loss.item()} vs cpu {loss_cpu.item()}")
            check(grad_rel <= gate,
                  f"lm-train (ssm-a) {arch} {mode}: leaf {worst} at {grad_rel} (gate {gate})")
            check(repeat, f"lm-train (ssm-a) {arch} {mode}: two steps on the card differ")
            check(not any(launches.values()), f"lm-train (ssm-a) {arch}: scans launched {launches}")
            del grads
        del g_cpu
        del model_card, model_cpu
        gc.collect()
        torch.cuda.empty_cache()


def ssm_train_restart(dev, card) -> None:
    """(ssm-b) each of ``SSM_TRAIN`` at ``SSM_RESTART_DEPTH``, bf16 activations, f32
    master weights, AdamW, ``SyntheticTokens`` 2 x 512: ``SSM_TRAIN_STEPS``
    steps of ``train_lm`` under ``invertible`` without checkpoints (per step
    wall, tokens/s, peak memory, scan launches: 0), then, for the models of
    ``SSM_RESTART``, the same run from the same seed with checkpoints,
    failed at its last step and restarted from the checkpoint before it:
    the final weights and every loss bitwise the first run's."""
    import shutil
    import tempfile

    import torch
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import Model
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.loop import train_lm

    kernels = scan_kernels()
    n = SSM_TRAIN_STEPS
    for i, (arch, _depth, _why) in enumerate(SSM_TRAIN):
        depth = SSM_RESTART_DEPTH[arch]
        cfg = get_arch(arch).config.replace(n_layers=depth)
        data = SyntheticTokens(cfg.vocab_size, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, seed=19)
        seed = SEED + 84 + i
        model = Model(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
        clock = StepClock(profiled=False)
        reset(kernels)
        torch.cuda.reset_peak_memory_stats()
        clean = train_lm(model, data, TrainConfig(steps=n, lr=3e-4, warmup_steps=1, prefetch=0),
                         grad_mode="invertible", device=dev, injector=clock)
        clock.finish()
        launches = {k.name: k.launches / n for k in kernels}
        final = {k: v.clone() for k, v in model.state_dict().items()}
        walls = [1e3 * (b - a) for a, b in zip(clock.marks, clock.marks[1:])]
        n_params = sum(p.numel() for p in model.parameters())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        common = dict(model=arch, depth=depth, dtype=cfg.dtype,
                      batch=[SSM_TRAIN_BATCH, SSM_TRAIN_SEQ], steps=n, losses=clean.losses,
                      wall_ms=walls, tokens_per_s=[SSM_TRAIN_BATCH * SSM_TRAIN_SEQ / (w * 1e-3)
                                                   for w in walls],
                      peak_memory_bytes=clock.peaks[1:], scan_launches_per_step=launches,
                      n_params=n_params, card=card)
        check(len(clean.losses) == n and all(math.isfinite(v) for v in clean.losses)
              and 0 < clean.losses[0] < 2 * math.log(cfg.vocab_size),
              f"lm-train (ssm-b) {arch}: losses {clean.losses}")
        check(not any(launches.values()), f"lm-train (ssm-b) {arch}: scans launched {launches}")
        if arch not in SSM_RESTART:
            line("lm-train", part="ssm-b", restart="not run (SSM_RESTART)", **common)
            del final
            continue
        scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_ssm_"))
        try:
            model = Model(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
            tcfg = TrainConfig(steps=n, lr=3e-4, warmup_steps=1, prefetch=0,
                               checkpoint_every=n - 1, checkpoint_dir=str(scratch),
                               keep_checkpoints=1)
            t0 = time.perf_counter()
            res = train_lm(model, data, tcfg, grad_mode="invertible", device=dev,
                           injector=FailureInjector(fail_at=(n - 1,)))
            restart_s = time.perf_counter() - t0
            same = all(torch.equal(final[k], v) for k, v in model.state_dict().items())
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        line("lm-train", part="ssm-b", restarts=res.restarts, final_bitwise_equal=same,
             resumed_losses=res.losses, losses_bitwise_equal=res.losses == clean.losses[-1:],
             restart_run_s_with_saves_and_restore=restart_s, **common)
        check(res.restarts == 1 and same and res.losses == clean.losses[-1:],
              f"lm-train (ssm-b) {arch}: the restart differs")
        del model, final
        gc.collect()
        torch.cuda.empty_cache()


def ssm_train_memory(dev, card) -> None:
    """(ssm-c) peak memory of one train step (loss, gradient, AdamW) of each
    ``SSM_MEM`` model at two depths, full width, bf16, under ``invertible``
    and ``autodiff``: the peak above the bytes held when the step starts,
    whose growth with depth under ``invertible`` must stay below a quarter
    of ``autodiff``'s (the quarter rule of ``[memory]``)."""
    import torch
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, adamw_update

    kernels = scan_kernels()
    for arch, depths, bsz, seq in SSM_MEM:
        config = get_arch(arch).config
        batch = {k: v.to(dev) for k, v in SyntheticTokens(
            config.vocab_size, seq, bsz, seed=23).batch_at(0).items()}
        above, steps_s = {}, {}
        reset(kernels)
        for mode in ("invertible", "autodiff"):
            for depth in depths:
                model = Model(config.replace(n_layers=depth),
                              generator=torch.Generator(dev).manual_seed(SEED + 88), device=dev)
                params = dict(model.named_parameters())
                opt = adamw_init(params)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                _loss, grads = lm_grads(model, batch, mode)
                adamw_update(params, grads, opt, TrainConfig(), 1e-4)
                torch.cuda.synchronize()
                key = f"{mode}_depth{depth}"
                steps_s[key] = time.perf_counter() - t0
                above[key] = torch.cuda.max_memory_allocated() - start
                del model, params, opt, grads
                gc.collect()
                torch.cuda.empty_cache()
        launches = {k.name: k.launches for k in kernels}
        lo, hi = depths
        growth = {m: above[f"{m}_depth{hi}"] - above[f"{m}_depth{lo}"]
                  for m in ("invertible", "autodiff")}
        line("lm-train", part="ssm-c", model=arch, depths=list(depths), batch=[bsz, seq],
             dtype=config.dtype, above_step_start_bytes=above, step_s=steps_s,
             growth_bytes={f"{m}_depth{lo}_to_{hi}": g for m, g in growth.items()},
             growth_vs_autodiff=growth["invertible"] / max(growth["autodiff"], 1),
             scan_launches=launches, card=card)
        check(growth["invertible"] < 0.25 * growth["autodiff"],
              f"lm-train (ssm-c) {arch}: invertible grew {growth['invertible']} B, "
              f"autodiff {growth['autodiff']} B")
        check(not any(launches.values()), f"lm-train (ssm-c) {arch}: scans launched {launches}")


# ---------------------------------------------------------------------------
# 12. the front ends: whisper-small (encoder, cross attention, audio frames)
#     and llava-next-34b (vision patches before the text), served and trained
# ---------------------------------------------------------------------------

WHISPER_FRAMES = 1500                    # the config's n_frames, whisper's own
WHISPER_PROMPT, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 64, 448, 4   # 448: its target limit
LLAVA_DEPTH = 8
LLAVA_WHY = ("depth 8 of 60: 21.5 GB of f32 weights (2.23 GB a layer, 3.67 GB embedding and "
             "head), for the script's time limit (16 until phase 15)")


def frontend_inputs(cfg, batch: int, positions: int, kind: str, generator) -> dict:
    """``batch_like(input_specs(...))``: tokens (and labels) with the model's
    features, ``positions`` counting a vision model's patches."""
    from repro_torch.config import ShapeSpec
    from repro_torch.models.registry import batch_like, input_specs

    return batch_like(input_specs(cfg, ShapeSpec(kind, positions, batch, kind)), generator,
                      cfg.vocab_size)


def frontend_vs_cpu(dev, card, arch, cfg, seed, train: bool) -> None:
    """``cfg`` (f32) on the card against the same weights on the CPU: prefill
    logits within ``TOL_LM_LOGITS`` of the largest and 8 greedy tokens equal
    (batch 2, a 64-token prompt after the features); with ``train``, the loss
    and every gradient leaf under ``invertible`` and ``autodiff`` at batch 2
    x 256 (``TOL_LOSS_REL``, ``TOL_GRAD_REL``)."""
    import torch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    model_card = Model(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    model_cpu = copy.deepcopy(model_card).cpu()
    n_prefix = cfg.frontend.n_patches if cfg.frontend.kind == "vision" else 0
    prompt = frontend_inputs(cfg, LM_CPU_BATCH, n_prefix + LM_CPU_PROMPT, "prefill",
                             torch.Generator().manual_seed(seed + 1))
    max_len = n_prefix + LM_CPU_PROMPT + LM_CPU_NEW
    reset((*ak.KERNELS, *scan_kernels()))
    logits, _ = model_card.prefill({k: v.to(dev) for k, v in prompt.items()},
                                   model_card.make_caches(LM_CPU_BATCH, max_len))
    tok, _ = ServeEngine(model_card, max_len, device=dev).generate(prompt, LM_CPU_NEW)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in (*ak.KERNELS, *scan_kernels())}
    t0 = time.perf_counter()
    logits_cpu, _ = model_cpu.prefill(prompt, model_cpu.make_caches(LM_CPU_BATCH, max_len))
    tok_cpu, _ = ServeEngine(model_cpu, max_len, device="cpu").generate(prompt, LM_CPU_NEW)
    cpu_s = time.perf_counter() - t0
    rel = (logits.cpu() - logits_cpu).abs().max().item() / logits_cpu.abs().max().item()
    depth = (f"{cfg.n_layers}" if not cfg.is_enc_dec
             else f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder")
    width = "reduced" if cfg.name.endswith("-reduced") else "full"
    line("serve", model=arch, width=width, depth=depth, dtype="float32", batch=LM_CPU_BATCH,
         features={k: list(v.shape) for k, v in prompt.items() if v.is_floating_point()},
         prompt=LM_CPU_PROMPT, new_tokens=LM_CPU_NEW, prefill_logits_rel_err_vs_cpu=rel,
         greedy_tokens_equal=bool(torch.equal(tok.cpu(), tok_cpu)), launches=launches,
         cpu_reference_s=cpu_s, card=card)
    check(torch.isfinite(logits).all().item() and rel <= TOL_LM_LOGITS,
          f"{arch} {width} f32 prefill logits vs cpu: {rel} of the largest")
    check(torch.equal(tok.cpu(), tok_cpu), f"{arch} greedy tokens differ: {tok} vs {tok_cpu}")
    check(not any(launches.values()), f"{arch}: kernels launched {launches}")
    if train:
        seq = n_prefix + (LM_CMP_SEQ if width == "full" else 16)
        batch = frontend_inputs(cfg, LM_CMP_BATCH, seq, "train",
                                torch.Generator().manual_seed(seed + 2))
        batch_dev = {k: v.to(dev) for k, v in batch.items()}
        for mode in ("invertible", "autodiff"):
            t0 = time.perf_counter()
            loss_cpu, g_cpu = lm_grads(model_cpu, batch, mode)
            cpu_s = time.perf_counter() - t0
            loss, grads = lm_grads(model_card, batch_dev, mode)
            loss2, grads2 = lm_grads(model_card, batch_dev, mode)
            torch.cuda.synchronize()
            repeat = bool(torch.equal(loss, loss2)) and all(torch.equal(grads[k], grads2[k])
                                                             for k in grads)
            loss_rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
            grad_rel, worst = max_rel_leaf_err(grads, g_cpu)
            unused = sorted(k for k, g in g_cpu.items() if not g.abs().max().item())
            line("lm-train", part="frontend-a", model=arch, width=width, depth=depth,
                 dtype="float32", batch={k: list(v.shape) for k, v in batch.items()},
                 grad_mode=mode, loss=loss.item(), loss_rel_err_vs_cpu=loss_rel,
                 grad_max_rel_err_vs_cpu=grad_rel, worst_leaf=worst, bitwise_repeatable=repeat,
                 n_leaves=len(grads), zero_leaves=unused, cpu_s=cpu_s, card=card)
            check(torch.isfinite(loss).item() and loss_rel <= TOL_LOSS_REL,
                  f"{arch} {mode}: loss {loss.item()} vs cpu {loss_cpu.item()}")
            check(grad_rel <= TOL_GRAD_REL, f"{arch} {mode}: leaf {worst} at {grad_rel}")
            check(repeat, f"{arch} {mode}: two steps on the card differ")
            del grads, grads2, g_cpu
    del model_card, model_cpu
    gc.collect()
    torch.cuda.empty_cache()


def frontend_serve(dev, card, arch, cfg, seed, n_prompt, why) -> dict:
    """``cfg`` on the card in bf16: ``generate`` at batch 8 with the model's
    features, ``n_prompt`` text tokens and 32 new ones, 0 kernel launches;
    tokens/s, peak memory.  Returns what ``lm_times`` reads."""
    import torch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_prefix = cfg.frontend.n_patches if cfg.frontend.kind == "vision" else 0
    batch = frontend_inputs(cfg, LM_BATCH, n_prefix + n_prompt, "prefill",
                            torch.Generator(dev).manual_seed(seed + 1))
    engine = ServeEngine(model, n_prefix + n_prompt + LM_NEW, device=dev)
    kernels = (*ak.KERNELS, *scan_kernels())
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    out, last = engine.generate(batch, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(out.shape == (LM_BATCH, LM_NEW) and torch.isfinite(last).all().item(),
          f"{arch} generate: tokens {tuple(out.shape)}, finite {torch.isfinite(last).all().item()}")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size, f"{arch} tokens outside vocab")
    check(not any(launches.values()), f"{arch} generate launched {launches}")
    n_params = sum(p.numel() for p in model.parameters())
    line("serve", model=arch, depth=cfg.n_layers, encoder_depth=cfg.encoder_layers or None,
         why_this_depth=why, dtype=cfg.dtype, batch=LM_BATCH,
         features={k: list(v.shape) for k, v in batch.items() if v.is_floating_point()},
         prompt=n_prompt, positions_before_decode=n_prefix + n_prompt, new_tokens=LM_NEW,
         n_params=n_params, f32_weight_bytes=4 * n_params, init_on_card_s=init_s,
         generate_s=gen_s,
         generate_tokens_per_s=LM_BATCH * (n_prefix + n_prompt + LM_NEW) / gen_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches_per_generate=launches,
         first_tokens=out[:, :4].tolist(), distinct_tokens=int(out.unique().numel()), card=card)
    served = {"model": model, "prompt": batch["tokens"], "batch": batch, "pos": n_prefix + n_prompt,
              "positions": LM_BATCH * (n_prefix + n_prompt)}
    if cfg.is_enc_dec:
        with torch.inference_mode():
            served["extra"] = {"enc": model.encode(batch["frames"])}
    return served


def whisper_train(dev, card) -> None:
    """(frontend-b) whisper-small whole, bf16 activations, f32 master
    weights, AdamW: ``WHISPER_TRAIN_STEPS`` steps of ``train_lm`` under
    ``invertible`` at 8 x 448 decoder tokens with 1500 frames each
    (``SpecBatches``): per step wall, tokens/s, peak memory; every loss
    finite, the first in (0, 2 log V)."""
    import torch
    from repro_torch.config import ShapeSpec, TrainConfig, get_arch
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.models import Model
    from repro_torch.models.registry import SpecBatches
    from repro_torch.train.loop import train_lm

    cfg = get_arch("whisper-small").config
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 93), device=dev)
    data = SpecBatches(cfg, ShapeSpec("train", WHISPER_TRAIN_SEQ, LM_BATCH, "train"), seed=29)
    kernels = (*ak.KERNELS, *scan_kernels())
    clock = StepClock(profiled=False)
    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    res = train_lm(model, data, TrainConfig(steps=WHISPER_TRAIN_STEPS, lr=3e-4, warmup_steps=1),
                   grad_mode="invertible", device=dev, injector=clock)
    clock.finish()
    launches = {k.name: k.launches for k in kernels}
    walls = [1e3 * (b - a) for a, b in zip(clock.marks, clock.marks[1:])]
    line("lm-train", part="frontend-b", model="whisper-small", depth=cfg.n_layers,
         encoder_depth=cfg.encoder_layers, dtype=cfg.dtype,
         batch={k: list(v.shape) for k, v in data.specs.items()}, losses=res.losses,
         wall_ms=walls, decoder_tokens_per_s=[LM_BATCH * WHISPER_TRAIN_SEQ / (w * 1e-3)
                                              for w in walls],
         peak_memory_bytes=clock.peaks[1:], launches=launches,
         n_params=sum(p.numel() for p in model.parameters()), card=card)
    check(len(res.losses) == WHISPER_TRAIN_STEPS and all(math.isfinite(v) for v in res.losses)
          and 0 < res.losses[0] < 2 * math.log(cfg.vocab_size),
          f"lm-train (frontend-b) whisper-small: losses {res.losses}")
    check(not any(launches.values()), f"lm-train (frontend-b): kernels launched {launches}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def frontend_phase(dev, card, wall_ms) -> None:
    """Phase 12: whisper-small (a) at full width, 2 encoder and 2 decoder
    layers, f32, against the CPU: prefill logits, 8 greedy tokens, the loss
    and every leaf; then whole in bf16: ``generate`` (batch 8, 1500 frames,
    a 64-token prompt, 32 new tokens) with ``[times]``, then (b)
    ``train_lm`` at 8 x 448.  llava-next-34b at full width, depth 2, f32,
    against the CPU (serving); at ``LLAVA_DEPTH`` in bf16 (batch 8, 576
    patches and 1472 text tokens, 2048 positions, 32 new tokens) with
    ``[times]``; ``REDUCED`` in f32: a train step against the CPU."""
    import torch
    from repro_torch.config import get_arch

    whisper = get_arch("whisper-small").config
    frontend_vs_cpu(dev, card, "whisper-small",
                    whisper.replace(n_layers=2, encoder_layers=2, dtype="float32"), SEED + 90,
                    train=True)
    served = frontend_serve(dev, card, "whisper-small", whisper, SEED + 91, WHISPER_PROMPT,
                            "whole: 12 encoder and 12 decoder layers")
    lm_times(served, card, wall_ms, name="whisper-small")
    del served
    gc.collect()
    torch.cuda.empty_cache()
    whisper_train(dev, card)
    spec = get_arch("llava-next-34b")
    frontend_vs_cpu(dev, card, "llava-next-34b", spec.config.replace(n_layers=2, dtype="float32"),
                    SEED + 94, train=False)
    frontend_vs_cpu(dev, card, "llava-next-34b", spec.reduced.replace(dtype="float32"),
                    SEED + 95, train=True)
    n_prefix = spec.config.frontend.n_patches
    served = frontend_serve(dev, card, "llava-next-34b",
                            spec.config.replace(n_layers=LLAVA_DEPTH), SEED + 96,
                            LM_PROMPT - n_prefix, LLAVA_WHY)
    lm_times(served, card, wall_ms, name="llava-next-34b")
    del served
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 13. distribution: two ranks share the card over gloo (data-parallel
#     training, the supervised loop, sharded serving, GPipe, the launchers)
# ---------------------------------------------------------------------------

DIST_WORLD = 2
#: a rank that hangs fails its collectives after this many seconds, and the
#: phase fails when its ranks have not finished by the join's limit
DIST_PG_TIMEOUT_S, DIST_JOIN_TIMEOUT_S = 60.0, 240.0
DIST_LOOP_STEPS = 3                    # (b): int8-compressed train_flow steps
DIST_PIPE = (2, 2, 512, 4, 8)          # (d), (e): stages, blocks a stage, width, M, microbatch
DIST_PIPE_STEPS = 4                    # (d), (e): train_pipeline steps
#: (e): four ranks on a (data 2, pipe 2) mesh, a gloo world of their own
DIST_PIPE_WORLD, DIST_PIPE_MESH = 4, (2, 2)
TOL_DIST = 1e-4                        # of each leaf's (output's) largest entry
TOL_DIST_PIPE = 1e-5                   # (e): against the one-axis run, relative


def _dist_flow(dev, state, psum_axis=None):
    """``GLOW_SCANNED`` (3 scales x 8 steps, hidden 64, Haar) holding
    ``state``, with the chain's ``psum_axis``."""
    from repro_torch.configs.flows import GLOW_SCANNED
    from repro_torch.core import build_glow_scanned

    flow = build_glow_scanned(n_scales=GLOW_SCANNED.n_scales, k_steps=GLOW_SCANNED.k_steps,
                              hidden=GLOW_SCANNED.hidden, grad_mode="coupled",
                              coupled_bwd="reversible", psum_axis=psum_axis, device=dev)
    flow.load_state_dict(state)
    return flow


def dist_rank(rank: int, world: int, scratch: str):
    """One rank of phase 13 (a process of its own on ``cuda:0``, the gloo
    world of ``world`` ranks over a file store in ``scratch``): (a) the
    data-parallel gradient and step, (b) the supervised loop with a restart,
    (c) sharded serving, (d) GPipe on a ``("pipe",)`` mesh.  Writes its results to
    ``scratch/out<rank>.pt``, or its traceback to ``scratch/err<rank>.txt``."""
    import traceback

    import torch

    entered = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's default weight-gradient convolutions add with atomics: the
        # step is bitwise repeatable on its deterministic ones
        torch.backends.cudnn.deterministic = True
        from repro_torch.launch.mesh import init_world, make_auto_mesh

        backend = init_world("cuda", init_method=f"file://{scratch}/store", rank=rank,
                             world_size=world, timeout_s=DIST_PG_TIMEOUT_S)
        in_world = time.time()
        check(backend == "gloo", f"rank {rank}: ranks sharing one card took {backend}")
        mesh = make_auto_mesh((world, 1), device_type="cuda")
        payload = torch.load(f"{scratch}/payload.pt", weights_only=False)
        out = {"rank": rank, "backend": backend, "seconds": {}}
        for part, run in (("a", lambda: _dist_dp(rank, mesh, payload)),
                          ("b", lambda: _dist_loop(rank, mesh, payload, scratch)),
                          ("c", lambda: _dist_serve(rank, mesh, payload)),
                          ("d", lambda: _dist_pipeline(rank, world))):
            t0 = time.perf_counter()
            out.update(run())
            out["seconds"][part] = time.perf_counter() - t0
        out["clock"] = {"entered": entered, "in_world": in_world, "done": time.time()}
        torch.save(out, f"{scratch}/out{rank}.pt")
    except BaseException:
        Path(f"{scratch}/err{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as tdist

        if tdist.is_initialized():
            tdist.destroy_process_group()


def _dist_kernels():
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.flowstep import flowstep as kern

    return (*kern.KERNELS, *ckern.KERNELS)


def _dist_dp(rank, mesh, payload) -> dict:
    """(a) ``dp_value_and_grad_nll`` with the reduction overlapped into the
    backward (``psum_axis="data"``) and trailing it, against the
    one-process step at batch 8; the step twice bitwise; one
    ``make_dp_train_step`` update dense, ``topk`` (ratio 0.01) and ``int8``
    with their wire bytes; ``topk`` at ratio 1.0 against the dense sum."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core.objectives import nll_loss
    from repro_torch.dist import comm, dp_value_and_grad_nll, shard_batch
    from repro_torch.dist.step import make_dp_train_step
    from repro_torch.optim import adamw_init, compressed_allreduce, compression_init
    from repro_torch.train.loop import objective_value_and_grad

    dev = torch.device("cuda")
    kernels = _dist_kernels()
    x = payload["x"].to(dev)
    flow_o = _dist_flow(dev, payload["state"], "data")
    flow_t = _dist_flow(dev, payload["state"])
    check(flow_o.psum_axis == "data" and flow_t.psum_axis is None, "psum_axis not in effect")
    runs = []
    for step in (1, 2):
        reset(kernels)
        comm.reset_wire_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = dp_value_and_grad_nll(flow_o, mesh)(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        runs.append((loss, grads))
        check(all(g.device.type == "cuda" for g in grads.values()), "gradients left the card")
        check(launches == {"flowstep_fwd": 24, "flowstep_inv": 0, "spine_bwd": 24,
                           "coupling_fwd": 0, "coupling_inv": 0, "coupling_bwd": 24},
              f"rank {rank} dp step {step} launches: {launches}")
        line("dist", part="a", rank=rank, step=step, reduction="overlapped", wall_ms=wall_ms,
             launches=launches, wire=comm.wire_bytes(), card=payload["card"])
    (loss, grads), (loss2, grads2) = runs
    bitwise = bool(torch.equal(loss, loss2)) and all(torch.equal(grads[k], grads2[k])
                                                     for k in grads)
    loss_t, grads_t = dp_value_and_grad_nll(flow_t, mesh)(x)
    ref_loss, ref_grads = payload["loss"], payload["grads"]
    loss_rel = abs(loss.item() - ref_loss) / abs(ref_loss)
    grad_rel, worst = max_rel_leaf_err(grads, ref_grads)
    ot_rel, ot_worst = max_rel_leaf_err(grads, grads_t)
    check(loss_rel <= TOL_LOSS_REL and grad_rel <= TOL_DIST,
          f"rank {rank}: dp step vs one process: loss {loss_rel}, grad {grad_rel} at {worst}")
    check(ot_rel <= TOL_DIST, f"rank {rank}: overlapped vs trailing {ot_rel} at {ot_worst}")
    check(bitwise, f"rank {rank}: the dp step run twice differs")
    del runs, grads2, grads_t

    # one update per reduction: dense (overlapped), topk and int8
    wire, step_ms = {}, {}
    for method, ratio in (("none", 0.01), ("topk", 0.01), ("int8", 0.01)):
        f = flow_o if method == "none" else flow_t
        f.load_state_dict(payload["state"])
        cfg = TrainConfig(steps=4, grad_compression=method, compression_ratio=ratio)
        step = make_dp_train_step(lambda b, f=f: (nll_loss(f, b), {}), f, cfg, mesh,
                                  grads_reduced_by_vjp=method == "none")
        params = dict(f.named_parameters())
        err = {} if method == "none" else compression_init(params)
        comm.reset_wire_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _state, metrics = step({"opt": adamw_init(params), "err": err}, shard_batch(x, mesh), 0)
        torch.cuda.synchronize()
        step_ms[method] = 1e3 * (time.perf_counter() - t0)
        wire[method] = comm.wire_bytes()
        check(math.isfinite(float(metrics["loss"])), f"rank {rank}: {method} step loss")
    for method in ("topk", "int8"):
        check(wire[method]["total"] < wire["none"]["total"]
              and wire[method]["by_op"].get("all_reduce", 0) <= 8,
              f"rank {rank}: {method} wire bytes {wire[method]} vs dense {wire['none']}")

    # topk at ratio 1.0 sends everything: the dense sum
    flow_t.load_state_dict(payload["state"])
    local = objective_value_and_grad(flow_t, lambda b: (nll_loss(flow_t, b) / 2, {}))(
        shard_batch(x, mesh))[1]
    zeros = compression_init(dict(flow_t.named_parameters()))
    with comm.bound(mesh):
        dense, _ = compressed_allreduce(local, zeros, "none", "data")
        full, residual = compressed_allreduce(local, zeros, "topk", "data", 1.0)
    topk_rel, _ = max_rel_leaf_err(full, dense)
    topk_bitwise = all(torch.equal(full[k], dense[k]) for k in dense)
    check(topk_rel <= 1e-6 and all(float(r.abs().max()) == 0.0 for r in residual.values()),
          f"rank {rank}: topk at ratio 1.0 vs dense {topk_rel}")
    result = {"loss": loss.item(), "loss_rel_err_vs_one_process": loss_rel,
              "grad_max_rel_err_vs_one_process": grad_rel, "worst_leaf": worst,
              "overlapped_vs_trailing_max_rel_err": ot_rel, "bitwise_repeatable": bitwise,
              "dp_step_launches": launches, "update_ms": step_ms, "wire": wire,
              "topk_ratio1_vs_dense_max_rel_err": topk_rel, "topk_ratio1_bitwise": topk_bitwise}
    line("dist", part="a", rank=rank, **result, card=payload["card"])
    return {"a": result}


def _dist_loop(rank, mesh, payload, scratch) -> dict:
    """(b) ``train_flow(mesh=...)``, int8-compressed, ``DIST_LOOP_STEPS``
    steps with a checkpoint each, uninterrupted and killed at its last step
    and restarted: bitwise equal."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.loop import train_flow

    dev = torch.device("cuda")
    data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 91)
    runs = {}
    for name, prefetch, injector in (("uninterrupted", 2, None),
                                     ("restarted", 0,
                                      FailureInjector(fail_at=(DIST_LOOP_STEPS - 1,)))):
        flow = _dist_flow(dev, payload["state"])
        cfg = TrainConfig(steps=DIST_LOOP_STEPS, lr=1e-4, warmup_steps=1, checkpoint_every=1,
                          checkpoint_dir=f"{scratch}/ck_{name}", prefetch=prefetch,
                          grad_compression="int8")
        t0 = time.perf_counter()
        res = train_flow(flow, data, cfg, device=dev, mesh=mesh, injector=injector)
        runs[name] = (res, {k: v.detach().clone() for k, v in flow.state_dict().items()},
                      time.perf_counter() - t0)
    (a, sa, ta), (b, sb, tb) = runs["uninterrupted"], runs["restarted"]
    same = (all(torch.equal(sa[k], sb[k]) for k in sa) and b.losses == a.losses[-1:]
            and all(torch.equal(a.err_state[k], b.err_state[k]) for k in a.err_state))
    check(b.restarts == 1 and same and all(math.isfinite(v) for v in a.losses),
          f"rank {rank}: the restarted mesh run differs ({a.losses} vs {b.losses})")
    result = {"losses": a.losses, "restarts": b.restarts, "bitwise_equal": same,
              "uninterrupted_s": ta, "restarted_s": tb, "checkpoint": f"{scratch}/ck_uninterrupted"}
    line("dist", part="b", rank=rank, **result, card=payload["card"])
    return {"b": result}


def _dist_serve(rank, mesh, payload) -> dict:
    """(c) ``FlowServeEngine(mesh=...)`` ``log_prob`` and ``sample`` at batch
    8 against the one-process engine, and each rank's launches."""
    import torch
    from repro_torch.serve.engine import FlowServeEngine

    dev = torch.device("cuda")
    kernels = _dist_kernels()
    engine = FlowServeEngine(_dist_flow(dev, payload["state"]), device=dev, mesh=mesh)
    like = tuple(torch.empty(s, device="meta") for s in payload["like"])
    reset(kernels)
    lp = engine.log_prob(payload["x"].to(dev))
    torch.cuda.synchronize()
    lp_launches = {k.name: k.launches for k in kernels if k.launches}
    reset(kernels)
    samples = engine.sample(torch.Generator(dev).manual_seed(SEED + 92), like)
    torch.cuda.synchronize()
    sample_launches = {k.name: k.launches for k in kernels if k.launches}
    ref_lp, ref_s = payload["log_prob"], payload["samples"]
    lp_rel = ((lp.cpu() - ref_lp).abs() / ref_lp.abs()).max().item()
    s_err = (samples.cpu() - ref_s).abs().max().item() / ref_s.abs().max().item()
    check(lp_launches == {"flowstep_fwd": 24} and sample_launches == {"flowstep_inv": 24},
          f"rank {rank}: sharded serving launches {lp_launches}, {sample_launches}")
    check(lp_rel <= TOL_DIST and s_err <= TOL_DIST,
          f"rank {rank}: sharded log_prob {lp_rel}, sample {s_err}")
    result = {"log_prob_max_rel_err": lp_rel, "sample_max_err_of_scale": s_err,
              "log_prob_bitwise": bool(torch.equal(lp.cpu(), ref_lp)),
              "sample_bitwise": bool(torch.equal(samples.cpu(), ref_s)),
              "log_prob_launches": lp_launches, "sample_launches": sample_launches}
    line("dist", part="c", rank=rank, **result, card=payload["card"])
    return {"c": result}


def _pipe_forward(rank, mesh, part: str) -> dict:
    """A 2-stage ``pipeline_forward`` of tanh blocks on the card over the
    mesh's ``pipe`` axis and its gradient against the same blocks in
    sequence on the card (part (d) on a ``("pipe",)`` mesh, (e) on a (data,
    pipe) one); the output comes back for the replicas' bitwise check."""
    import torch
    from repro_torch.dist import comm, pipeline_forward, pipeline_stage_fn

    stages, l_per, d, m, mb = DIST_PIPE
    s = mesh.get_local_rank("pipe")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 93)
    w = (torch.randn(stages, l_per, d, d, generator=g) / math.sqrt(d)).to(dev)
    b = (0.1 * torch.randn(stages, l_per, d, generator=g)).to(dev)
    x = torch.randn(m, mb, d, generator=g).to(dev)
    gy = torch.randn(m, mb, d, generator=g).to(dev)

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    wl, bl = w[s].clone().requires_grad_(), b[s].clone().requires_grad_()
    comm.reset_wire_bytes()
    out = pipeline_forward(pipeline_stage_fn(block, l_per), {"w": wl, "b": bl}, x, mesh)
    gw, gb = torch.autograd.grad(out, [wl, bl], gy)
    wire = comm.wire_bytes()
    ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
    h = x
    for i_s in range(stages):
        for i in range(l_per):
            h = block({"w": ws[i_s, i], "b": bs[i_s, i]}, h)
    rw, rb = torch.autograd.grad(h, [ws, bs], gy)
    errs = {"out": (out - h).abs().max().item() / h.abs().max().item(),
            "gw": (gw - rw[s]).abs().max().item() / rw[s].abs().max().item(),
            "gb": (gb - rb[s]).abs().max().item() / rb[s].abs().max().item()}
    check(max(errs.values()) <= 1e-5, f"rank {rank} ({part}): pipeline vs sequence {errs}")
    result = {"stage": s, "stages": stages, "blocks_per_stage": l_per, "width": d,
              "microbatches": m, "max_rel_err": errs, "out_bitwise": bool(torch.equal(out, h)),
              "wire": wire}
    line("dist", part=part, rank=rank, mesh=list(mesh.mesh_dim_names), **result)
    return {**result, "out": out.detach().cpu(), "gw": gw.cpu(), "gb": gb.cpu()}


def _pipe_train(mesh) -> dict:
    """``train_pipeline`` of the same tanh blocks with a linear head,
    ``DIST_PIPE_STEPS`` steps at batch M x microbatch on the card: the
    losses, the final parameters (on the CPU) and the wire bytes."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.dist import comm
    from repro_torch.train.loop import train_pipeline

    stages, l_per, d, m, mb = DIST_PIPE
    g = torch.Generator().manual_seed(SEED + 94)
    init = {"stages": {"w": torch.randn(stages, l_per, d, d, generator=g) / math.sqrt(d),
                       "b": 0.1 * torch.randn(stages, l_per, d, generator=g)},
            "head": 0.1 * torch.randn(d, 1, generator=g)}

    class Data:
        def batch_at(self, step):
            x = torch.randn(m * mb, d, generator=torch.Generator().manual_seed(SEED + 95 + step))
            return {"x": x, "y": torch.sin(x.sum(-1, keepdim=True) / math.sqrt(d))}

    comm.reset_wire_bytes()
    res = train_pipeline(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         lambda: {"stages": {k: v.clone() for k, v in init["stages"].items()},
                                  "head": init["head"].clone()}, Data(),
                         TrainConfig(steps=DIST_PIPE_STEPS, lr=1e-4, warmup_steps=1,
                                     pipeline_microbatches=m),
                         mesh=mesh, n_layers_per_stage=l_per, device="cuda",
                         loss_head=lambda p, h, batch: torch.mean(
                             (h @ p["head"] - batch["y"]) ** 2))
    check(len(res.losses) == DIST_PIPE_STEPS and all(math.isfinite(v) for v in res.losses),
          f"train_pipeline on {mesh.mesh_dim_names}: losses {res.losses}")
    return {"losses": res.losses, "params": {k: v.cpu() for k, v in res.params.items()},
            "wire": comm.wire_bytes()}


def _dist_pipeline(rank, world) -> dict:
    """(d) the 2-stage pipeline on a ``("pipe",)`` mesh: the forward and
    gradient against the blocks in sequence, and ``train_pipeline``, the
    one-axis run that part (e) is held to."""
    from repro_torch.launch.mesh import make_auto_mesh

    mesh = make_auto_mesh((world,), ("pipe",), device_type="cuda")
    result = _pipe_forward(rank, mesh, "d")
    result["train"] = _pipe_train(mesh)
    return {"d": result}


def pipe_mesh_rank(rank: int, world: int, scratch: str):
    """One rank of phase 13's part (e): ``DIST_PIPE_WORLD`` processes on
    ``cuda:0`` in a gloo world of their own (a file store in ``scratch``), a
    ``(data 2, pipe 2)`` mesh: the pipeline's forward and gradient against
    the blocks in sequence, and ``train_pipeline``.  Writes its results to
    ``scratch/pipe_out<rank>.pt``, or its traceback to
    ``scratch/pipe_err<rank>.txt``."""
    import traceback

    import torch

    entered = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.launch.mesh import init_world, make_auto_mesh

        backend = init_world("cuda", init_method=f"file://{scratch}/pipe_store", rank=rank,
                             world_size=world, timeout_s=DIST_PG_TIMEOUT_S)
        in_world = time.time()
        check(backend == "gloo", f"rank {rank}: ranks sharing one card took {backend}")
        mesh = make_auto_mesh(DIST_PIPE_MESH, ("data", "pipe"), device_type="cuda")
        out = {"rank": rank, "coord": {a: mesh.get_local_rank(a) for a in ("data", "pipe")},
               "backend": backend}
        t0 = time.perf_counter()
        out["e"] = _pipe_forward(rank, mesh, "e")
        t1 = time.perf_counter()
        out["e"]["train"] = _pipe_train(mesh)
        out["seconds"] = {"forward": t1 - t0, "train": time.perf_counter() - t1}
        out["clock"] = {"entered": entered, "in_world": in_world, "done": time.time()}
        torch.save(out, f"{scratch}/pipe_out{rank}.pt")
    except BaseException:
        Path(f"{scratch}/pipe_err{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as tdist

        if tdist.is_initialized():
            tdist.destroy_process_group()


def pipe_mesh_check(outs: list, one_axis: dict, card) -> dict:
    """Part (e) held together: each stage's two data replicas bitwise equal
    (outputs, gradients, losses, parameters), the losses within
    ``TOL_DIST_PIPE`` of the one-axis run's and the parameters within it of
    their scale."""
    import torch

    by_stage: dict = {}
    for o in outs:
        by_stage.setdefault(o["coord"]["pipe"], []).append(o)
    check(sorted(by_stage) == [0, 1] and all(len(v) == 2 for v in by_stage.values()),
          f"dist (e): ranks by stage {[o['coord'] for o in outs]}")
    replicas_bitwise = all(
        torch.equal(a["e"][k], b["e"][k])
        for a, b in by_stage.values() for k in ("out", "gw", "gb"))
    first = outs[0]["e"]["train"]
    params_bitwise = all(o["e"]["train"]["losses"] == first["losses"] and all(
        torch.equal(v, o["e"]["train"]["params"][k]) for k, v in first["params"].items())
        for o in outs[1:])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], one_axis["losses"]))
    param_rel, worst = max_rel_leaf_err(first["params"], one_axis["params"])
    vs_one_axis_bitwise = first["losses"] == one_axis["losses"] and all(
        torch.equal(v, one_axis["params"][k]) for k, v in first["params"].items())
    check(replicas_bitwise, "dist (e): the data replicas' pipeline outputs differ")
    check(params_bitwise, "dist (e): train_pipeline's losses or parameters differ across ranks")
    check(loss_rel <= TOL_DIST_PIPE and param_rel <= TOL_DIST_PIPE,
          f"dist (e): vs the one-axis run: losses {loss_rel}, parameters {param_rel} at {worst}")
    result = {"mesh": list(DIST_PIPE_MESH), "axes": ["data", "pipe"],
              "max_rel_err_vs_sequence": {k: max(o["e"]["max_rel_err"][k] for o in outs)
                                          for k in ("out", "gw", "gb")},
              "replicas_bitwise": replicas_bitwise, "losses": first["losses"],
              "one_axis_losses": one_axis["losses"], "loss_max_rel_err_vs_one_axis": loss_rel,
              "param_max_rel_err_vs_one_axis": param_rel, "params_bitwise_across_ranks":
              params_bitwise, "bitwise_vs_one_axis": vs_one_axis_bitwise,
              "rank_seconds": {o["rank"]: o["seconds"] for o in outs},
              "forward_wire_per_rank": {o["rank"]: o["e"]["wire"] for o in outs},
              "train_wire_per_rank": {o["rank"]: o["e"]["train"]["wire"] for o in outs}}
    line("dist", part="e-summary", **result, card=card)
    return result


def dist_phase(dev, card) -> dict:
    """Phase 13 ``[dist]``: ``DIST_WORLD`` ranks share ``cuda:0`` over
    ``gloo`` (NCCL refuses two ranks on one device), each a process started
    here with the kernels this process built, and beside them the
    ``DIST_PIPE_WORLD`` ranks of part (e) in a world of their own; they
    check correctness and count wire bytes, and measure no scaling.  Then,
    here: (e)'s ranks held to each other and to (d)'s one-axis run, (b) the
    elastic restore of the ranks' int8 checkpoint onto one process (the
    residuals re-zeroed, with a warning) and (f) ``--mesh auto`` through the
    train launcher (a world of 1: a (1, 1) mesh).  Returns the per-rank
    launches of the DP step and of sharded serving."""
    import multiprocessing
    import os
    import shutil
    import tempfile
    import warnings

    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import value_and_grad_nll
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.serve.engine import FlowServeEngine
    from repro_torch.train.loop import train_flow

    scratch = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    launcher = None
    try:
        flow = build_flow(GLOW_SCANNED, channels=3, generator=torch.Generator().manual_seed(
            SEED + 90), device=dev)
        perturb(flow, SEED + 91)
        x = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 90).batch_at(0)
        loss, grads = value_and_grad_nll(flow, x.to(dev))
        engine = FlowServeEngine(flow, device=dev)
        with torch.inference_mode():
            z, _ = engine.flow(x.to(dev))
        like = tuple(torch.empty_like(v, device="meta") for v in z)
        lp = engine.log_prob(x)
        samples = engine.sample(torch.Generator(dev).manual_seed(SEED + 92), like)
        torch.save({"state": {k: v.cpu() for k, v in flow.state_dict().items()}, "x": x,
                    "loss": loss.item(), "grads": {k: v.cpu() for k, v in grads.items()},
                    "log_prob": lp.cpu(), "samples": samples.cpu(),
                    "like": [tuple(v.shape) for v in like], "card": card},
                   f"{scratch}/payload.pt")
        del flow, grads, engine

        # (f) the train launcher with --mesh auto (a world of 1, a (1, 1)
        # mesh), run beside the ranks: it trains lg-smoke, a small model
        argv = ["repro_torch.launch.train", "--scenario", "lg-smoke", "--mesh", "auto",
                "--steps", "8", "--ckpt", f"{scratch}/launcher"]
        t0 = time.perf_counter()
        with open(f"{scratch}/launcher.out", "w") as out, open(f"{scratch}/launcher.err", "w") as err:
            launcher = subprocess.Popen([sys.executable, "-m", *argv], stdout=out, stderr=err,
                                        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        # (a)-(d): DIST_WORLD ranks; (e): DIST_PIPE_WORLD ranks in a world of
        # their own, started beside them
        ctx = multiprocessing.get_context("spawn")
        worlds = {"": (dist_rank, DIST_WORLD), "pipe_": (pipe_mesh_rank, DIST_PIPE_WORLD)}
        procs = {(tag, r): ctx.Process(target=fn, args=(r, world, scratch))
                 for tag, (fn, world) in worlds.items() for r in range(world)}
        spawned = time.time()
        for p in procs.values():
            p.start()
        deadline = time.monotonic() + DIST_JOIN_TIMEOUT_S
        for p in procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [key for key, p in procs.items() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
        errs = {key: Path(f"{scratch}/{key[0]}err{key[1]}.txt").read_text()[-3000:]
                for key in procs if Path(f"{scratch}/{key[0]}err{key[1]}.txt").exists()}
        check(not hung, f"dist: ranks {hung} still running after {DIST_JOIN_TIMEOUT_S} s: {errs}")
        check(not errs and all(p.exitcode == 0 for p in procs.values()),
              f"dist: exit codes {[p.exitcode for p in procs.values()]}: {errs}")
        outs = [torch.load(f"{scratch}/out{r}.pt", weights_only=False) for r in range(DIST_WORLD)]
        pipe_outs = [torch.load(f"{scratch}/pipe_out{r}.pt", weights_only=False)
                     for r in range(DIST_PIPE_WORLD)]
        ranks_s = time.perf_counter() - t0
        # each rank's clock from the spawn: entered, in its world, done
        clocks = {f"{tag}{o['rank']}": {k: round(v - spawned, 3) for k, v in o["clock"].items()}
                  for tag, group in (("", outs), ("pipe_", pipe_outs)) for o in group}
        pipe_mesh = pipe_mesh_check(pipe_outs, outs[0]["d"]["train"], card)

        # (b) elastic restore: the 2-rank int8 checkpoint onto one process
        ckdir = outs[0]["b"]["checkpoint"]
        flow = build_flow(GLOW_SCANNED, channels=3, device=dev)
        data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 91)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = train_flow(flow, data, TrainConfig(
                steps=DIST_LOOP_STEPS + 1, lr=1e-4, warmup_steps=1, checkpoint_every=1,
                checkpoint_dir=ckdir, grad_compression="int8"), device=dev)
        rezeroed = any("residuals re-zeroed" in str(w.message) for w in caught)
        check(rezeroed and res.final_step == DIST_LOOP_STEPS and len(res.losses) == 1
              and math.isfinite(res.losses[0]),
              f"dist (b): elastic restore onto one process: {[str(w.message) for w in caught]}, "
              f"losses {res.losses}")
        line("dist", part="b-elastic", world_before=DIST_WORLD, world_after=1,
             residuals_rezeroed_warning=rezeroed, resumed_at_step=DIST_LOOP_STEPS,
             losses=res.losses, card=card)
        del flow

        try:
            launcher.wait(timeout=DIST_JOIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait()
        stdout = Path(f"{scratch}/launcher.out").read_text()
        stderr = Path(f"{scratch}/launcher.err").read_text()
        out_lines = stdout.strip().splitlines()
        line("dist", part="f", argv=argv, returncode=launcher.returncode,
             seconds_since_start=time.perf_counter() - t0, stdout=out_lines[-4:],
             stderr_tail=stderr.strip().splitlines()[-5:], card=card)
        check(launcher.returncode == 0 and any("mesh=1x1 backend=" in ln for ln in out_lines)
              and any("done at step 7" in ln for ln in out_lines),
              f"dist (f): --mesh auto launcher: {stdout[-2000:]} {stderr[-2000:]}")
    finally:
        if launcher is not None and launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        shutil.rmtree(scratch, ignore_errors=True)
    a = [o["a"] for o in outs]
    line("dist", part="summary", world=DIST_WORLD, backend=outs[0]["backend"],
         ranks_s=ranks_s, rank_seconds={o["rank"]: o["seconds"] for o in outs},
         rank_clocks_from_spawn=clocks,
         grad_max_rel_err_vs_one_process=max(r["grad_max_rel_err_vs_one_process"] for r in a),
         overlapped_vs_trailing=max(r["overlapped_vs_trailing_max_rel_err"] for r in a),
         bitwise_repeatable=all(r["bitwise_repeatable"] for r in a),
         wire_bytes={m: a[0]["wire"][m] for m in a[0]["wire"]},
         sharded_serving={k: outs[0]["c"][k] for k in ("log_prob_bitwise", "sample_bitwise",
                                                       "log_prob_max_rel_err",
                                                       "sample_max_err_of_scale")},
         pipeline_mesh={k: pipe_mesh[k] for k in (
             "replicas_bitwise", "loss_max_rel_err_vs_one_axis", "param_max_rel_err_vs_one_axis",
             "bitwise_vs_one_axis")},
         note="ranks share one card: correctness and wire bytes, not scaling", card=card)
    return {"dp_step_per_rank": a[0]["dp_step_launches"],
            "sharded_log_prob_per_rank": outs[0]["c"]["log_prob_launches"],
            "sharded_sample_per_rank": outs[0]["c"]["sample_launches"]}


# ---------------------------------------------------------------------------
# 14. model-sharded meshes: two ranks share the card over gloo on a (1, 2)
#     mesh (model-sharded training, expert-parallel and sequence-parallel
#     serving, the launchers)
# ---------------------------------------------------------------------------

MESH_STEPS = 3                         # (a): model-sharded train_flow steps
MESH_LM = "granite-moe-1b-a400m"       # (b): served at full width, a cut depth
MESH_LM_DEPTH = 2
MESH_LM_WHY = ("depth 2 of 24: each rank gathers a superblock's 54 M f32 weights whole "
               "(216 MB) at every prefill and decode step through gloo's host staging, "
               "and the script must end inside its time limit (4 took 128 s on a slow host)")
MESH_BATCH, MESH_PROMPT, MESH_NEW = 2, 512, 16


def mesh_rank(rank: int, world: int, scratch: str):
    """One rank of phase 14 (a process of its own on ``cuda:0``, the gloo
    world of ``world`` ranks on a (1, 2) mesh over a file store in
    ``scratch``): (a) model-sharded ``GLOW_SCANNED`` training, sampling and
    the elastic restore, (b) ``ServeEngine`` on the model-sharded mesh.
    Writes ``scratch/out<rank>.pt``, or its traceback to ``err<rank>.txt``."""
    import traceback

    import torch

    entered = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        from repro_torch.launch.mesh import init_world, make_auto_mesh

        backend = init_world("cuda", init_method=f"file://{scratch}/store", rank=rank,
                             world_size=world, timeout_s=DIST_PG_TIMEOUT_S)
        check(backend == "gloo", f"rank {rank}: ranks sharing one card took {backend}")
        mesh = make_auto_mesh((1, world), device_type="cuda")
        payload = torch.load(f"{scratch}/payload.pt", weights_only=False)
        out = {"rank": rank, "backend": backend}
        out.update(_mesh_flow(rank, mesh, payload, scratch))
        out.update(_mesh_serve(rank, mesh, payload))
        out["dryrun"] = dryrun_rank(rank, world, payload)
        torch.save(out, f"{scratch}/out{rank}.pt")
    except BaseException:
        Path(f"{scratch}/err{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as tdist

        if tdist.is_initialized():
            tdist.destroy_process_group()


def _mesh_flow(rank, mesh, payload, scratch) -> dict:
    """(a) ``train_flow`` of ``GLOW_SCANNED`` with every leaf stored as this
    rank's block, ``MESH_STEPS`` steps twice (bitwise), against the
    one-process run; the kernels' launches a step; one step's wire bytes by
    collective; ``sample`` (the inverse) on the sharded flow; the elastic
    restore of the (1, 2) checkpoint onto a (2, 1) mesh."""
    import warnings

    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core.objectives import nll_loss
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dist import comm
    from repro_torch.dist.model import ModelSharding
    from repro_torch.dist.step import make_sharded_train_step
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import train_flow

    dev = torch.device("cuda")
    kernels = _dist_kernels()
    data = SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 101)
    ckdir = f"{scratch}/ck_mesh"
    runs = []
    for rep in (1, 2):
        flow = _dist_flow(dev, payload["state"])
        cfg = TrainConfig(steps=MESH_STEPS, lr=1e-4, warmup_steps=1, prefetch=0,
                          checkpoint_dir=ckdir if rep == 2 else None,
                          checkpoint_every=MESH_STEPS)
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_flow(flow, data, cfg, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        runs.append((res, {k: v.detach().clone() for k, v in flow.state_dict().items()},
                     launches, wall_s))
    (a, sa, la, ta), (b, sb, lb, tb) = runs
    per_step = {k: n / MESH_STEPS for k, n in la.items() if n}
    check(per_step == {"flowstep_fwd": 24, "spine_bwd": 24, "coupling_bwd": 24} and la == lb,
          f"rank {rank}: model-sharded step launches {la}, {lb}")
    bitwise = a.losses == b.losses and all(torch.equal(sa[k], sb[k]) for k in sa)
    check(bitwise, f"rank {rank}: the model-sharded run repeated differs: {a.losses} {b.losses}")
    ref_losses, ref_state = payload["train_losses"], payload["train_state"]
    loss_rel = max(abs(x - r) / abs(r) for x, r in zip(a.losses, ref_losses))
    leaf_rel, worst = max_rel_leaf_err({k: v for k, v in sa.items() if v.is_floating_point()},
                                       {k: v for k, v in ref_state.items()
                                        if v.is_floating_point()})
    check(loss_rel <= TOL_DIST and leaf_rel <= TOL_DIST,
          f"rank {rank}: model-sharded vs one process: loss {loss_rel}, leaf {leaf_rel} at {worst}")

    # one step alone: its wire bytes by collective
    flow = _dist_flow(dev, payload["state"])
    sharding = ModelSharding(flow, mesh).shard()
    params = dict(flow.named_parameters())
    step = make_sharded_train_step(lambda x: (nll_loss(flow, x), {}), flow,
                                   TrainConfig(steps=1, lr=1e-4), mesh, sharding)
    comm.reset_wire_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step({"opt": adamw_init(params), "err": {}}, data.batch_at(0).to(dev), 0)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    step_wire = comm.wire_bytes()

    # sample: the inverse on the sharded flow (a step's slice gathered at a
    # time), from the one-process run's noise
    flow.load_state_dict(sharding.local_tree(payload["state"]))
    z = tuple(v.to(dev) for v in payload["z"])
    reset(kernels)
    with torch.inference_mode(), comm.bound(mesh):
        samples = flow.inverse(z)
    torch.cuda.synchronize()
    sample_launches = {k.name: k.launches for k in kernels if k.launches}
    s_err = ((samples.cpu() - payload["samples"]).abs().max().item()
             / payload["samples"].abs().max().item())
    check(sample_launches == {"flowstep_inv": 24} and s_err <= TOL_DIST,
          f"rank {rank}: sharded sample launches {sample_launches}, err {s_err}")
    sharding.unshard()
    del flow, sharding

    # elastic: the (1, 2) checkpoint restored onto a (2, 1) mesh, with the
    # warning that the mesh changed
    mesh21 = make_auto_mesh((2, 1), device_type="cuda")
    flow = _dist_flow(dev, payload["state"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res21 = train_flow(flow, data, TrainConfig(steps=MESH_STEPS + 1, lr=1e-4, warmup_steps=1,
                                                   prefetch=0, checkpoint_dir=ckdir,
                                                   checkpoint_every=1), device=dev, mesh=mesh21)
    warned = any("written under mesh [1, 2]" in str(w.message) for w in caught)
    check(warned and res21.final_step == MESH_STEPS and len(res21.losses) == 1
          and math.isfinite(res21.losses[0]),
          f"rank {rank}: elastic (1, 2) -> (2, 1): {[str(w.message) for w in caught]}, "
          f"{res21.losses}")
    result = {"losses": a.losses, "loss_max_rel_err_vs_one_process": loss_rel,
              "leaf_max_rel_err_vs_one_process": leaf_rel, "worst_leaf": worst,
              "bitwise_repeatable": bitwise, "launches_per_step": per_step,
              "run_s": [ta, tb], "one_step_ms": step_ms, "one_step_wire": step_wire,
              "stored_bytes": a.shard_bytes, "sample_launches": sample_launches,
              "sample_max_err_of_scale": s_err, "elastic_warned": warned,
              "elastic_losses": res21.losses}
    line("mesh", part="a", rank=rank, **result, card=payload["card"])
    return {"a": result}


def _mesh_serve(rank, mesh, payload) -> dict:
    """(b) ``ServeEngine(mesh=...)`` of ``MESH_LM`` at full width and
    ``MESH_LM_DEPTH`` layers with ``attn_seq_shard``, in f32 and in the
    config's bf16: its parameters stored as this rank's blocks, expert
    parallelism and sequence-parallel attention, against the one-process
    engine on the card."""
    return {"b": {dtype: _mesh_serve_one(rank, mesh, payload, dtype) for dtype in MESH_DTYPES}}


def _mesh_serve_one(rank, mesh, payload, dtype: str) -> dict:
    """(b) in one activation dtype.  Gates: every greedy step's logits,
    prefill and decode, within ``MESH_LOGITS_TOL[dtype]`` of that step's
    largest while the tokens before it are the one-process engine's (f32:
    phase 10's ``TOL_LM_LOGITS``; bf16: ``TOL_BF16``, on the one-process
    engine's routing of every step, since an expert choice at a near tie
    flips under the sharded paths' f32 reordering and moves the logits past
    rounding; the unpinned first step's flips and error are reported); in
    f32 the greedy tokens equal to the one-process engine's (in bf16 they
    can part only where the one-process margin is inside the logits gate,
    and where they part is reported); 16 experts a rank."""
    import contextlib

    import torch
    from repro_torch.dist import comm
    from repro_torch.models import Model
    from repro_torch.nn import moe
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda")
    cfg = mesh_lm_config(dtype).replace(attn_seq_shard=True)
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 102), device=dev)
    n_whole = sum(p.numel() * p.element_size() for p in model.parameters())
    engine = ServeEngine(model, MESH_PROMPT + MESH_NEW, device=dev, mesh=mesh)
    n_stored = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = {"tokens": payload["prompt"].to(dev)}
    ref = payload["lm"][dtype]
    experts, steps = [], []
    orig, sample = moe.ffn_apply, engine._sample

    def counting(p, x, kind):
        experts.append(int(x.shape[0]))
        return orig(p, x, kind)

    def recording(logits, gen):
        steps.append(logits.float().cpu())
        return sample(logits, gen)

    # bf16 decodes on the one-process engine's routing of every step
    routing = moe.pinned_routes(ref["routes"]) if dtype == "bfloat16" \
        else contextlib.nullcontext()
    moe.ffn_apply = counting
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouteLog() as routes:
            _tok1, first = engine.generate(prompt, 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        comm.reset_wire_bytes()
        engine._sample = recording
        t0 = time.perf_counter()
        with routing:
            toks, last = engine.generate(prompt, MESH_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        wire = comm.wire_bytes()
    finally:
        moe.ffn_apply, engine._sample = orig, sample
    n_first = len(routes.calls)
    flips = sum(int((a != b).sum()) for a, b in zip(routes.calls, ref["routes"][:n_first]))
    # generate(prompt, 1) returns the logits after its one token: step 1's
    scale = ref["step_logits"][1].abs().max().item()
    err = (first.cpu().float() - ref["step_logits"][1]).abs().max().item() / scale
    step_errs = step_logit_errors(toks.cpu(), ref["tokens"], steps, ref["step_logits"])
    tokens_equal = bool(torch.equal(toks.cpu(), ref["tokens"]))
    tie = near_tie(toks.cpu(), ref["tokens"], ref["step_logits"])
    check(tokens_equal or dtype != "float32",
          f"rank {rank} {dtype}: mesh tokens {toks.tolist()} vs one process "
          f"{ref['tokens'].tolist()} ({tie})")
    check(max(step_errs) <= MESH_LOGITS_TOL[dtype] and torch.isfinite(last).all().item()
          and (dtype != "float32" or err <= MESH_LOGITS_TOL[dtype]),
          f"rank {rank} {dtype}: step logits vs one process {step_errs} of each step's "
          f"largest (first step unpinned {err})")
    check(set(experts) == {cfg.moe.n_experts // 2},
          f"rank {rank} {dtype}: experts run a call {sorted(set(experts))}")
    result = {"model": MESH_LM, "depth": MESH_LM_DEPTH, "of_depth": 24, "why": MESH_LM_WHY,
              "dtype": dtype, "batch": MESH_BATCH, "prompt": MESH_PROMPT,
              "new_tokens": MESH_NEW, "routing": "one process's" if dtype == "bfloat16"
              else "its own", "tokens_equal_one_process": tokens_equal,
              "first_differing_token": tie,
              "unpinned_first_logits_rel_err_of_largest": err,
              "step_logits_rel_err_of_largest": step_errs,
              "gate": MESH_LOGITS_TOL[dtype], "unpinned_first_step_routing_flips": flips,
              "routing_choices": sum(c.numel() for c in routes.calls),
              "experts_a_call": sorted(set(experts)),
              "stored_param_bytes": n_stored, "whole_param_bytes": n_whole,
              "prefill_s": prefill_s, "generate_s": gen_s,
              "decode_step_ms": 1e3 * (gen_s - prefill_s) / (MESH_NEW - 1), "wire": wire}
    line("mesh", part="b", rank=rank, **result, card=payload["card"])
    del engine, model
    torch.cuda.empty_cache()
    return result


def step_logit_errors(toks, ref_toks, steps, ref_steps) -> list:
    """Each greedy step's largest |logit| error against the one-process
    engine, as a share of that step's largest |logit|, over the sequences
    whose tokens before the step are all the one-process engine's; the
    steps after every sequence has parted are not compared."""
    import torch

    same = torch.ones(toks.shape[0], dtype=torch.bool)
    out = []
    for i, (a, r) in enumerate(zip(steps, ref_steps)):
        if not same.any():
            break
        out.append(((a[same] - r[same]).abs().max() / r[same].abs().max()).item())
        same &= toks[:, i] == ref_toks[:, i]
    return out


def near_tie(toks, ref_toks, ref_step_logits) -> dict | None:
    """Where two greedy decodes of one batch first part: the sequence, the
    step, and the one-process engine's logit of the mesh's token below its
    largest at that step, as a share of that step's largest |logit|; None
    when every token is equal."""
    diff = (toks != ref_toks).nonzero()
    if not len(diff):
        return None
    b, i = (int(v) for v in diff[diff[:, 1].argmin()])
    logits = ref_step_logits[i][b]
    gap = (logits.max() - logits[int(toks[b, i])]).item()
    return {"sequence": b, "step": i, "gap_of_largest": gap / logits.abs().max().item()}


MESH_DTYPES = ("float32", "bfloat16")
MESH_LOGITS_TOL = {"float32": TOL_LM_LOGITS, "bfloat16": TOL_BF16}


def mesh_lm_config(dtype: str):
    from repro_torch.config import get_arch

    return get_arch(MESH_LM).config.replace(n_layers=MESH_LM_DEPTH, dtype=dtype)


def _mesh_lm_reference(dev, prompt) -> dict:
    """The one-process engine's greedy tokens, each step's logits and the
    routing of every step, per dtype, on the card."""
    import torch
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    out = {}
    for dtype in MESH_DTYPES:
        model = Model(mesh_lm_config(dtype), generator=torch.Generator(dev).manual_seed(SEED + 102),
                      device=dev)
        engine = ServeEngine(model, MESH_PROMPT + MESH_NEW, device=dev)
        steps = []
        sample = engine._sample

        def recording(logits, gen):
            steps.append(logits.float().cpu())
            return sample(logits, gen)

        engine._sample = recording
        with RouteLog() as routes:
            tokens, _ = engine.generate({"tokens": prompt}, MESH_NEW)
        engine._sample = sample
        out[dtype] = {"tokens": tokens.cpu(), "routes": routes.calls, "step_logits": steps}
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


MESH_LAUNCHERS = (
    ("train-arch", ["repro_torch.launch.train", "--arch", MESH_LM, "--reduced", "--steps", "2",
                    "--seq", "32", "--batch", "4", "--mesh", "1,2"]),
    ("serve-arch", ["repro_torch.launch.serve", "--arch", MESH_LM, "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--max-new", "8", "--mesh", "1,2"]),
    ("train-flow", ["repro_torch.launch.train", "--scenario", "images-prior-scanned",
                    "--steps", "2", "--mesh", "1,2"]),
)


def mesh_phase(dev, card) -> dict:
    """Phase 14 ``[mesh]``: two ranks share ``cuda:0`` over ``gloo`` on a
    (1, 2) mesh (NCCL refuses two ranks on one device), each a process
    started here with the kernels this process built; (c) the three
    launchers with ``--mesh 1,2`` under ``torch.distributed.run`` run at
    once from the phase's start, beside the one-process references (which
    are not timed), and end before the ranks start, so that no other
    process shares the card while the ranks time their steps.  They check
    correctness and count bytes; they measure no scaling.  Returns the
    per-rank launches of the model-sharded step and sample."""
    import multiprocessing
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.train.loop import train_flow

    scratch = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    launchers = []
    t0 = time.perf_counter()
    try:
        # (c) the launchers on --mesh 1,2 (two processes each, over gloo on
        # this card), all three at once: serve draws its weights from the
        # seed (the CPU tests serve a checkpoint the --arch training wrote)
        for i, (name, argv) in enumerate(MESH_LAUNCHERS):
            ckpt = [] if name == "serve-arch" else ["--ckpt", f"{scratch}/{name}"]
            with open(f"{scratch}/launch{i}.out", "w") as out, \
                    open(f"{scratch}/launch{i}.err", "w") as err:
                launchers.append(subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2", "-m", *argv, *ckpt], stdout=out, stderr=err,
                    cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}))

        # the one-process references on the card, deterministic cuDNN as the
        # ranks run it
        torch.backends.cudnn.deterministic = True
        flow = build_flow(GLOW_SCANNED, channels=3, generator=torch.Generator().manual_seed(
            SEED + 100), device=dev)
        perturb(flow, SEED + 101)
        state = {k: v.detach().cpu().clone() for k, v in flow.state_dict().items()}
        with torch.inference_mode():
            z0, _ = flow(SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 103)
                         .batch_at(0).to(dev))
            z = std_normal_like(z0, SEED + 104)
            samples = flow.inverse(z)
        one = _dist_flow(dev, state)
        res = train_flow(one, SyntheticImages(HW, channels=3, batch=BATCH, seed=SEED + 101),
                         TrainConfig(steps=MESH_STEPS, lr=1e-4, warmup_steps=1, prefetch=0),
                         device=dev)
        train_state = {k: v.detach().cpu().clone() for k, v in one.state_dict().items()}
        del flow, one
        prompt = torch.randint(0, mesh_lm_config("float32").vocab_size,
                               (MESH_BATCH, MESH_PROMPT),
                               generator=torch.Generator().manual_seed(SEED + 105))
        lm = _mesh_lm_reference(dev, prompt)
        torch.backends.cudnn.deterministic = False
        torch.save({"state": state, "z": tuple(v.cpu() for v in z), "samples": samples.cpu(),
                    "train_losses": res.losses, "train_state": train_state, "prompt": prompt,
                    "lm": lm, "card": card}, f"{scratch}/payload.pt")
        gc.collect()
        torch.cuda.empty_cache()

        for launcher in launchers:
            try:
                launcher.wait(timeout=DIST_JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait()
        stdout = "".join(Path(f"{scratch}/launch{i}.out").read_text()
                         for i in range(len(launchers)))
        stderr = "".join(Path(f"{scratch}/launch{i}.err").read_text()
                         for i in range(len(launchers)))
        line("mesh", part="c", launchers=[" ".join(a) for _, a in MESH_LAUNCHERS],
             returncodes=[x.returncode for x in launchers],
             seconds_since_start=time.perf_counter() - t0,
             stdout=[ln for ln in stdout.splitlines() if "mesh=" in ln or "done at" in ln
                     or "generated" in ln], stderr_tail=stderr.strip().splitlines()[-5:],
             card=card)
        # the two ranks of a launcher print to one stream: count the phrases
        check(all(x.returncode == 0 for x in launchers)
              and stdout.count("mesh=1x2 backend=gloo") == 6
              and stdout.count(f"arch={MESH_LM}-reduced device=cuda mesh=1x2: generated "
                               "(2, 8)") == 2
              and stdout.count("done at step 1") == 4,
              f"mesh (c): launchers: {stdout[-3000:]} {stderr[-2000:]}")

        t_ranks = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, DIST_WORLD, scratch))
                 for r in range(DIST_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = {r: Path(f"{scratch}/err{r}.txt").read_text()[-3000:] for r in range(DIST_WORLD)
                if Path(f"{scratch}/err{r}.txt").exists()}
        check(not hung, f"mesh: ranks {hung} still running after {DIST_JOIN_TIMEOUT_S} s: {errs}")
        check(not errs and all(p.exitcode == 0 for p in procs),
              f"mesh: exit codes {[p.exitcode for p in procs]}: {errs}")
        outs = [torch.load(f"{scratch}/out{r}.pt", weights_only=False) for r in range(DIST_WORLD)]
        ranks_s = time.perf_counter() - t_ranks
    finally:
        torch.backends.cudnn.deterministic = False
        for launcher in launchers:
            if launcher.poll() is None:
                launcher.kill()
                launcher.wait()
        shutil.rmtree(scratch, ignore_errors=True)
    a, b = [o["a"] for o in outs], [o["b"] for o in outs]
    line("mesh", part="summary", world=DIST_WORLD, shape=[1, DIST_WORLD],
         backend=outs[0]["backend"], ranks_s=ranks_s,
         leaf_max_rel_err_vs_one_process=max(r["leaf_max_rel_err_vs_one_process"] for r in a),
         bitwise_repeatable=all(r["bitwise_repeatable"] for r in a),
         stored_bytes_rank0=a[0]["stored_bytes"], one_step_wire=a[0]["one_step_wire"],
         serve_tokens_equal=all(r[t]["tokens_equal_one_process"] for r in b for t in r),
         serve_stored_fraction=b[0]["bfloat16"]["stored_param_bytes"]
         / b[0]["bfloat16"]["whole_param_bytes"],
         prefill_s={t: [r[t]["prefill_s"] for r in b] for t in MESH_DTYPES},
         decode_step_ms={t: [r[t]["decode_step_ms"] for r in b] for t in MESH_DTYPES},
         serve_wire=b[0]["bfloat16"]["wire"],
         note="two ranks share one card: correctness and wire bytes, not scaling", card=card)
    return {"step_per_rank": a[0]["launches_per_step"],
            "sample_per_rank": a[0]["sample_launches"],
            "dryrun": [o["dryrun"] for o in outs]}


DRY_TRAIN_ARCH, DRY_TRAIN_DEPTH = "granite-moe-1b-a400m", 2   # (a): 2 of 24 layers, f32
DRY_TRAIN_ROWS, DRY_TRAIN_SEQ, DRY_STEPS = 2, 512, 3          # a rank's rows, positions
DRY_VARIANTS = ("zero1", "fsdp", "zero1-fsdp")
DRY_REPEAT = "zero1-fsdp"               # run twice, bitwise: both options at once
TOL_DRY = 1e-5                          # of each leaf's (loss's) largest, against one process
DRY_SERVE_ARCH, DRY_SERVE_DEPTH = "zamba2-7b", 7                # (b): a superblock and its tail
DRY_SERVE_BATCH, DRY_SERVE_PROMPT, DRY_SERVE_NEW = 2, 512, 8
DRY_PEAK_BAND = (0.8, 1.25)             # (c): measured over reckoned peak, [lm-train] (b)


def wire_kinds(wire: dict) -> dict:
    """``dist/comm.py``'s counts in the dry run's ``collectives`` layout."""
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "send": "collective-permute"}
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute"), 0)
    for op, n in wire["by_op"].items():
        out[kinds[op]] += n
    out["total"] = sum(wire["by_op"].values())
    out["count"] = sum(wire["calls"].values())
    return out


def dryrun_rank(rank: int, world: int, payload) -> dict:
    """Phase 15 ``[dryrun]`` in one of phase 14's ranks (the same gloo world
    on ``cuda:0``): (a) ``DRY_TRAIN_ARCH`` trained on a (2, 1) mesh and (b)
    ``DRY_SERVE_ARCH`` served on the (1, 2) mesh, each against the
    one-process run on the card, and each cell reckoned by the dry run on
    ``MeshSpec`` for this rank, whose argument and wire bytes must equal
    what the card stored and counted."""
    return {"a": _dry_train(rank, payload), "b": _dry_serve(rank, payload)}


def _dry_train(rank, payload) -> dict:
    """(a) ``DRY_STEPS`` steps of ``launch/dryrun.py::make_train_step`` under
    each of ``DRY_VARIANTS`` (``DRY_REPEAT`` twice), full width,
    ``DRY_TRAIN_DEPTH`` layers, f32, ``DRY_TRAIN_ROWS`` x ``DRY_TRAIN_SEQ`` a
    rank, no gradient clip.  Gates: the losses and every parameter within
    ``TOL_DRY`` of the one-process step's (each leaf's largest), the
    one-process step accumulating over the ranks' row blocks; bitwise on the
    repeat; the dry run's argument bytes equal to the rank's stored
    parameter and moment bytes plus its rows of the batch, and its
    collectives to the first step's wire, kind by kind."""
    import torch
    from repro_torch.config import ShapeSpec, TrainConfig, get_arch
    from repro_torch.dist import comm
    from repro_torch.launch.dryrun import dry_cell, make_train_step, parse_variant
    from repro_torch.launch.mesh import MeshSpec, make_auto_mesh
    from repro_torch.models import Model
    from repro_torch.models.registry import batch_like, input_specs

    dev = torch.device("cuda")
    cfg = get_arch(DRY_TRAIN_ARCH).config.replace(n_layers=DRY_TRAIN_DEPTH, dtype="float32")
    shape = ShapeSpec("dry-train", DRY_TRAIN_SEQ, 2 * DRY_TRAIN_ROWS, "train")
    batch = batch_like(input_specs(cfg, shape), torch.Generator().manual_seed(SEED + 110),
                       cfg.vocab_size)
    batch = {k: v.to(dev) for k, v in batch.items()}
    mesh = make_auto_mesh((2, 1), device_type="cuda")

    def run(on_mesh, zero1=False, fsdp=False, accum=1):
        model = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 111), device=dev)
        # no clip: the clip scale is 1 / the global norm, whose last bits
        # follow the order of its sum (the blocks' under zero1 and fsdp, the
        # whole leaves' in one process), and AdamW's moments, where a
        # gradient changes sign between steps, amplify a last-bit change of
        # the scale; the norms are reported
        step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=1, accum_steps=accum,
                                                  grad_clip=0.0),
                               mesh=mesh if on_mesh else None, zero1=zero1, fsdp=fsdp)
        state = step.init_state()
        losses, wire, walls, norms = [], None, [], []
        for _ in range(DRY_STEPS):
            comm.reset_wire_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            walls.append(1e3 * (time.perf_counter() - t0))
            wire = wire or comm.wire_bytes()
        named = {k: v.detach() for k, v in model.named_parameters()}
        whole = step.sharding.whole_tree(named) if step.sharding is not None else named
        stored = (step.sharding.resident_bytes(state["opt"]) if step.sharding is not None
                  else None)
        out = {"losses": losses, "grad_norms": norms,
               "params": {k: v.clone() for k, v in whole.items()},
               "wire": wire, "stored": stored, "stored_bytes": step.stored_bytes(state),
               "step_ms": walls}
        del step, model, state
        torch.cuda.empty_cache()
        return out

    # the one-process reference accumulates over the two ranks' row blocks,
    # the order in which the data axis sums: AdamW's first steps are nearly
    # sign(g), so a gradient element at the level of f32 reordering noise
    # flips by 2 lr under the plain one-process sum (1.11e-2 of a leaf's
    # scale in PERF.md's run 3 of this phase)
    ref = run(False, accum=2)
    results = {}
    for variant in DRY_VARIANTS:
        opts = parse_variant(variant)
        a = run(True, opts["zero1"], opts["fsdp"])
        bitwise = None
        if variant == DRY_REPEAT:
            b = run(True, opts["zero1"], opts["fsdp"])
            bitwise = a["losses"] == b["losses"] and all(
                torch.equal(v, b["params"][k]) for k, v in a["params"].items())
            a["step_ms"] += b["step_ms"]
            del b
        leaf, worst = max_rel_leaf_err(a["params"], ref["params"])
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref["losses"]))
        art = dry_cell(DRY_TRAIN_ARCH, shape, MeshSpec((2, 1), ("data", "model"), backend="gloo",
                                                       rank=rank), "2x1", variant, cfg=cfg)
        local = sum(v.numel() * v.element_size() for v in batch.values()) // 2
        counted = wire_kinds(a["wire"])
        res = {"variant": variant, "losses": a["losses"], "one_process_losses": ref["losses"],
               "loss_rel_err": loss_err, "leaf_max_rel_err": leaf, "worst_leaf": worst,
               "reference": "one process, accum_steps=2 (the ranks' row blocks)",
               "grad_norm_rel_err": max(abs(x - y) / y for x, y in zip(a["grad_norms"],
                                                                       ref["grad_norms"])),
               "bitwise_repeatable": bitwise, "step_ms": a["step_ms"],
               "stored": a["stored"], "one_process_stored_bytes": ref["stored_bytes"],
               "stored_bytes": a["stored_bytes"], "local_batch_bytes": local,
               "reckoned_argument_bytes": art["memory"]["argument_bytes"],
               "reckoned_peak_bytes": art["memory"]["peak_bytes"], "wire": counted,
               "reckoned_collectives": art["collectives"]}
        line("dryrun", part="a", rank=rank, model=DRY_TRAIN_ARCH, depth=DRY_TRAIN_DEPTH,
             of_depth=24, mesh=[2, 1], **res, card=payload["card"])
        check(loss_err <= TOL_DRY and leaf <= TOL_DRY,
              f"dryrun (a) {variant} rank {rank}: loss {loss_err}, leaf {leaf} ({worst}) "
              "of scale from one process")
        check(bitwise is not False, f"dryrun (a) {variant} rank {rank}: the repeat differs")
        check(art["memory"]["argument_bytes"] == a["stored_bytes"] + local,
              f"dryrun (a) {variant} rank {rank}: reckoned argument bytes "
              f"{art['memory']['argument_bytes']} vs stored {a['stored_bytes']} + batch {local}")
        check(art["collectives"] == counted,
              f"dryrun (a) {variant} rank {rank}: reckoned {art['collectives']} vs counted "
              f"{counted}")
        results[variant] = res
    del ref
    torch.cuda.empty_cache()
    return results


def _dry_serve(rank, payload) -> dict:
    """(b) ``ServeEngine(cache_seq_fallback=True)`` of ``DRY_SERVE_ARCH`` at
    full width and ``DRY_SERVE_DEPTH`` layers on the (1, 2) mesh, batch
    ``DRY_SERVE_BATCH``, a ``DRY_SERVE_PROMPT``-token prompt and
    ``DRY_SERVE_NEW`` new tokens, in f32 and, with the servefix bf16 weights,
    in bf16.  Gates: f32 tokens equal to the one-process engine's and each
    step's logits within ``TOL_LM_LOGITS``'s 5e-6 of that step's largest;
    bf16 each step within ``TOL_BF16`` (no MoE: nothing to pin); one
    ``ssd_scan`` a Mamba2 layer a rank a prefill, as the dry run reckons;
    the dry run's argument bytes equal to the rank's stored weights, rows
    and caches, and its collectives to the wire of one prefill and one
    decode step, each a request, kind by kind (the servefix cells)."""
    import torch
    from repro_torch.config import ShapeSpec, get_arch
    from repro_torch.dist import comm
    from repro_torch.kernels.ssd import ssd as sk
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import MeshSpec, make_auto_mesh
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda")
    mesh = make_auto_mesh((1, 2), device_type="cuda")
    max_len = DRY_SERVE_PROMPT + DRY_SERVE_NEW
    vocab = get_arch(DRY_SERVE_ARCH).config.vocab_size
    prompt = torch.randint(0, vocab, (DRY_SERVE_BATCH, DRY_SERVE_PROMPT), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED + 112)).to(dev)
    results = {}
    for dtype, bf16, tol in (("float32", False, 5e-6), ("bfloat16", True, TOL_BF16)):
        cfg = get_arch(DRY_SERVE_ARCH).config.replace(n_layers=DRY_SERVE_DEPTH, dtype=dtype)

        def engine_of(on_mesh):
            model = Model(cfg, generator=torch.Generator(dev).manual_seed(SEED + 113),
                          device=dev)
            return ServeEngine(model, max_len, device=dev, mesh=mesh if on_mesh else None,
                               cache_seq_fallback=on_mesh, serve_bf16=bf16)

        def generate(engine):
            steps, sample = [], engine._sample

            def recording(logits, gen):
                steps.append(logits.float().cpu())
                return sample(logits, gen)

            engine._sample = recording
            try:
                toks, _ = engine.generate({"tokens": prompt}, DRY_SERVE_NEW)
            finally:
                engine._sample = sample
            return toks.cpu(), steps

        one = engine_of(False)
        ref_toks, ref_steps = generate(one)
        del one
        torch.cuda.empty_cache()
        engine = engine_of(True)
        stored = sum(p.numel() * p.element_size() for p in engine.model.parameters())
        # a generate's prefill launches the scans (its decode steps run the
        # plain recurrence); its wire is not a sum of calls', since one
        # request gathers the leaves outside the stacks once for all of them
        reset(sk.KERNELS)
        comm.reset_wire_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, steps = generate(engine)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = sk.ssd_scan.launches
        errs = step_logit_errors(toks, ref_toks, steps, ref_steps)
        res = {"dtype": dtype, "tokens_equal_one_process": bool(torch.equal(toks, ref_toks)),
               "step_logits_rel_err_of_largest": errs, "gate": tol,
               "ssd_scan_per_prefill": launches, "generate_s": gen_s,
               "stored_param_bytes": stored, "generate_wire": wire_kinds(comm.wire_bytes())}
        if bf16:  # the servefix cells, reckoned
            mspec = MeshSpec((1, 2), ("data", "model"), backend="gloo", rank=rank)
            reck = {kind: dry_cell(DRY_SERVE_ARCH, ShapeSpec(f"dry-{kind}", DRY_SERVE_PROMPT
                                                             if kind == "prefill" else max_len,
                                                             DRY_SERVE_BATCH, kind),
                                   mspec, "1x2", "servefix", cfg=cfg, max_len=max_len)
                    for kind in ("prefill", "decode")}
            tok_bytes = {"prefill": prompt.numel() * prompt.element_size(),
                         "decode": DRY_SERVE_BATCH * 4}
            res["reckoned"] = {k: {"argument_bytes": a["memory"]["argument_bytes"],
                                   "peak_bytes": a["memory"]["peak_bytes"],
                                   "collectives": a["collectives"], "launches": a["launches"]}
                               for k, a in reck.items()}
            # one prefill and one decode step, each a request, as the dry run
            # reckons a cell: their wire, and the caches they are handed
            caches = engine.caches(DRY_SERVE_BATCH)
            cache_bytes = sum(v.numel() * v.element_size() for v in _leaves(caches))
            comm.reset_wire_bytes()
            logits, caches = engine.prefill({"tokens": prompt}, caches)
            counted = {"prefill": wire_kinds(comm.wire_bytes())}
            comm.reset_wire_bytes()
            engine.decode(logits.argmax(-1).to(torch.int32)[:, None], caches, max_len - 1)
            counted["decode"] = wire_kinds(comm.wire_bytes())
            del caches
            res.update(cache_bytes=cache_bytes, call_wire=counted)
            for kind, a in reck.items():
                check(a["memory"]["argument_bytes"] == stored + tok_bytes[kind] + cache_bytes,
                      f"dryrun (b) {kind} rank {rank}: reckoned argument bytes "
                      f"{a['memory']['argument_bytes']} vs stored {stored} + rows "
                      f"{tok_bytes[kind]} + caches {cache_bytes}")
                check(a["collectives"] == counted[kind],
                      f"dryrun (b) {kind} rank {rank}: reckoned {a['collectives']} vs counted "
                      f"{counted[kind]}")
            check(reck["prefill"]["launches"].get("ssd_scan") == launches,
                  f"dryrun (b) rank {rank}: {launches} ssd_scan a prefill, reckoned "
                  f"{reck['prefill']['launches']}")
        line("dryrun", part="b", rank=rank, model=DRY_SERVE_ARCH, depth=DRY_SERVE_DEPTH,
             of_depth=81, mesh=[1, 2], batch=DRY_SERVE_BATCH, prompt=DRY_SERVE_PROMPT,
             new_tokens=DRY_SERVE_NEW, **res, card=payload["card"])
        check(launches == DRY_SERVE_DEPTH,
              f"dryrun (b) {dtype} rank {rank}: {launches} ssd_scan a prefill, not one a layer")
        check(res["tokens_equal_one_process"] or dtype != "float32",
              f"dryrun (b) rank {rank}: f32 tokens {toks.tolist()} vs {ref_toks.tolist()}")
        check(errs and max(errs) <= tol,
              f"dryrun (b) {dtype} rank {rank}: step logits {errs} of each step's largest")
        results[dtype] = res
        del engine
        torch.cuda.empty_cache()
    return results


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def dryrun_phase(dev, card, ranks: list, peaks: list) -> dict:
    """Phase 15 ``[dryrun]``: the ranks' parts (a) and (b) (run in phase
    14's ranks), then (c) the dry run's reckoning of ``[lm-train]`` (b)'s
    cell (``LM_TRAIN_ARCH`` at ``LM_TRAIN_DEPTH`` layers, ``LM_TRAIN_BATCH``
    x ``LM_TRAIN_SEQ``, bf16 activations, on a (1, 1) mesh) against the peak
    memory that phase measured (``torch.cuda.max_memory_allocated`` over
    each step), with what ``train_lm`` holds beside the step (its copy of the
    initial state, for a restart before the first checkpoint) counted: the
    ratio gated to ``DRY_PEAK_BAND``.  Returns the
    ``ssd_scan`` launches a rank a prefill, counted and reckoned."""
    from repro_torch.config import ShapeSpec, get_arch
    from repro_torch.launch.dryrun import dry_cell, meta_model
    from repro_torch.launch.mesh import MeshSpec

    t0 = time.perf_counter()
    cfg = get_arch(LM_TRAIN_ARCH).config.replace(n_layers=LM_TRAIN_DEPTH)
    art = dry_cell(LM_TRAIN_ARCH, ShapeSpec("lm-train-b", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"),
                   MeshSpec((1, 1), ("data", "model")), "1x1", cfg=cfg)
    # what train_lm holds beside the step: the loop's copy of the initial
    # state, kept for a restart before the first checkpoint (train/loop.py,
    # ``initial``), one f32 copy of the parameters
    loop_copy = sum(v.numel() * v.element_size() for v in meta_model(cfg).state_dict().values())
    reckoned = art["memory"]["peak_bytes"] + loop_copy
    measured = max(peaks)
    ratio = measured / reckoned
    a = {v: {k: ranks[0]["a"][v][k] for k in ("leaf_max_rel_err", "loss_rel_err",
                                              "bitwise_repeatable", "stored",
                                              "one_process_stored_bytes")}
         for v in DRY_VARIANTS}
    b = {t: {k: ranks[0]["b"][t][k] for k in ("tokens_equal_one_process", "ssd_scan_per_prefill",
                                              "stored_param_bytes")}
         | {"step_logits_max": max(r["b"][t]["step_logits_rel_err_of_largest"] for r in ranks)}
         for t in ("float32", "bfloat16")}
    line("dryrun", part="c", model=LM_TRAIN_ARCH, depth=LM_TRAIN_DEPTH,
         batch=[LM_TRAIN_BATCH, LM_TRAIN_SEQ], measured_peak_bytes_by_step=peaks,
         measured_peak_bytes=measured, reckoned_peak_bytes=reckoned,
         reckoned_step_peak_bytes=art["memory"]["peak_bytes"], loop_initial_copy_bytes=loop_copy,
         reckoned_argument_bytes=art["memory"]["argument_bytes"],
         reckoned_temp_bytes=art["memory"]["temp_bytes"], ratio=ratio, band=DRY_PEAK_BAND,
         reckoned_flops=art["cost"]["flops"], reckoned_bytes=art["cost"]["bytes_accessed"],
         seconds_trace=art["seconds_trace"], card=card)
    line("dryrun", part="summary", a=a, b=b, peak_ratio=ratio,
         seconds=time.perf_counter() - t0, card=card)
    check(DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1],
          f"dryrun (c): measured peak {measured} over reckoned {reckoned} = {ratio}")
    return {"counted": ranks[0]["b"]["bfloat16"]["ssd_scan_per_prefill"],
            "reckoned": ranks[0]["b"]["bfloat16"]["reckoned"]["prefill"]["launches"].get(
                "ssd_scan")}


def std_normal_like(z, seed):
    """Standard-normal noise shaped like ``z`` (a tensor or a tuple), from a
    seeded generator on ``z``'s device."""
    import torch

    leaves = z if isinstance(z, tuple) else (z,)
    gen = torch.Generator(leaves[0].device).manual_seed(seed)
    out = tuple(torch.randn(v.shape, generator=gen, device=v.device) for v in leaves)
    return out if isinstance(z, tuple) else out[0]


def time_flow_kernels(dev) -> dict:
    """Phase 7, ``[times]`` of the eight flow kernels: the scanned model's
    at its three (B, M, C), the unrolled model's at its transformed halves
    and widths, f32 and bf16.  One PyTorch call computes each 1x1-conv
    function (TF32 off); none computes the flow step's or the coupling's."""
    import torch
    from repro_torch.kernels.conv1x1 import conv1x1 as c1kern
    from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref, conv1x1_mm_ref
    from repro_torch.kernels.coupling import coupling as ckern
    from repro_torch.kernels.coupling.ref import (coupling_bwd_ref, coupling_bwd_rows_ref,
                                                  coupling_fwd_ref, coupling_fwd_rows_ref,
                                                  coupling_inv_ref, coupling_inv_rows_ref)
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref, spine_bwd_ref

    per_shape = {"flowstep_fwd": [], "flowstep_inv": [], "spine_bwd": [], "coupling_bwd": []}
    for shape in SHAPES[:3]:
        for dtype in (torch.float32, torch.bfloat16):
            x_, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED)
            y_ = flowstep_fwd_ref(x_, ls, ab, w, raw, t)[0]
            w_inv = torch.linalg.inv(w)
            g_ = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 7)).to(dev, dtype)
            gld = torch.randn(shape[0], generator=torch.Generator().manual_seed(SEED + 8)).to(dev)
            ca = shape[-1] // 2
            runs = {
                "flowstep_fwd": (lambda: kern.flowstep_fwd(x_, ls, ab, w, raw, t),
                                 lambda: flowstep_fwd_ref(x_, ls, ab, w, raw, t)),
                "flowstep_inv": (lambda: kern.flowstep_inv(y_, ls, ab, w_inv, raw, t),
                                 lambda: flowstep_inv_ref(y_, ls, ab, w_inv, raw, t)),
                "spine_bwd": (lambda: kern.spine_bwd(x_, g_, w, w_inv, ls, ab),
                              lambda: spine_bwd_ref(x_, g_, w, w_inv, ls, ab)),
                "coupling_bwd": (lambda: ckern.coupling_bwd(y_[..., :ca], raw, t, g_[..., :ca], gld),
                                 lambda: coupling_bwd_ref(y_[..., :ca], raw, t, g_[..., :ca], gld)),
            }
            b, m, c = shape
            path = kern.spine_path(x_, g_)
            plan = kern.spine_plan(b * m, c, kern.spine_max_clusters(x_.device, dtype, c))
            flow_path = kern.flowstep_path(x_, raw, t)
            extra = {"spine_bwd": {"path": path, "plan": plan,
                                   "kernels_per_call": kern.spine_kernels_per_call(path, plan)},
                     **{name: {"path": flow_path, "plan": kern.FLOW_PLAN[c],
                               "kernels_per_call": kern.KERNELS_PER_CALL[name]}
                        for name in ("flowstep_fwd", "flowstep_inv")}}
            for name, (k_fn, p_fn) in runs.items():
                per_shape[name].append(time_kernel(name, shape, dtype, k_fn, p_fn,
                                                   **extra.get(name, {})))
    for name in ("coupling_fwd_rows", "coupling_inv_rows", "coupling_bwd_rows", "coupling_fwd",
                 "coupling_inv", "conv1x1_mm", "conv1x1_gw"):
        per_shape[name] = []
    for i in range(3):
        for dtype in (torch.float32, torch.bfloat16):
            # the layer's coupling op and its backward on whole rows (the
            # row streams), then the half kernels on the transformed half
            shape = SHAPES[i]
            xr, hr = row_inputs(shape, dtype, dev, SEED + 13)
            yr = coupling_fwd_rows_ref(xr, hr)[0]
            gr = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 23)).to(
                dev, dtype)
            gldr = torch.randn(shape[0], generator=torch.Generator().manual_seed(SEED + 24)).to(dev)
            c = shape[-1]
            path = ckern.coupling_path(xr, hr[..., : c // 2], hr[..., c // 2:])
            bwd_path = ckern.coupling_path(yr, hr[..., : c // 2], hr[..., c // 2:], gy=gr)
            for name, k_fn, p_fn, pth in (
                    ("coupling_fwd_rows", lambda: ckern.coupling_fwd.rows(xr, hr),
                     lambda: coupling_fwd_rows_ref(xr, hr), path),
                    ("coupling_inv_rows", lambda: ckern.coupling_inv.rows(yr, hr),
                     lambda: coupling_inv_rows_ref(yr, hr), path),
                    ("coupling_bwd_rows", lambda: ckern.coupling_bwd.rows(yr, hr, gr, gldr),
                     lambda: coupling_bwd_rows_ref(yr, hr, gr, gldr), bwd_path)):
                kernel = name.removesuffix("_rows")
                per_shape[name].append(time_kernel(
                    name, shape, dtype, k_fn, p_fn, path=pth, plan=ckern.COUPLING_PLAN,
                    kernels_per_call=ckern.KERNELS_PER_CALL.get(kernel, 1)))
            shape = COUPLING_SHAPES[i]
            xc, rc, tc = coupling_inputs(shape, dtype, dev, SEED + 13)
            per_shape["coupling_fwd"].append(time_kernel(
                "coupling_fwd", shape, dtype, lambda: ckern.coupling_fwd(xc, rc, tc),
                lambda: coupling_fwd_ref(xc, rc, tc), path="tile"))
            per_shape["coupling_inv"].append(time_kernel(
                "coupling_inv", shape, dtype, lambda: ckern.coupling_inv(xc, rc, tc),
                lambda: coupling_inv_ref(xc, rc, tc), path="tile"))
            shape = CONV1X1_SHAPES[i]
            xm, gm, wm = conv1x1_inputs(shape, dtype, dev, SEED + 14)
            wd = wm.to(dtype)
            c = shape[-1]
            per_shape["conv1x1_mm"].append(time_kernel(
                "conv1x1_mm", shape, dtype, lambda: c1kern.conv1x1_mm(xm, wm),
                lambda: conv1x1_mm_ref(xm, wm), lambda: torch.matmul(xm, wd),
                path=c1kern.mm_path(xm)))
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = c1kern.gw_plan(shape[0] * shape[1], c, xm.element_size(), n_sm)
            per_shape["conv1x1_gw"].append(time_kernel(
                "conv1x1_gw", shape, dtype, lambda: c1kern.conv1x1_gw(xm, gm),
                lambda: conv1x1_gw_ref(xm, gm),
                lambda: xm.reshape(-1, c).T @ gm.reshape(-1, c), path=c1kern.gw_path(xm, gm),
                kernels_per_call=1 if plan["clusters"] == 1 else 2, plan=plan))
    return per_shape


def main() -> int:
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.core import derive_key, std_normal_sample, value_and_grad_nll
    from repro_torch.kernels import common
    from repro_torch.kernels.flowstep import flowstep as kern
    from repro_torch.kernels.flowstep.ref import (flowstep_fwd_ref, flowstep_inv_ref,
                                                  flowstep_stream_ref)
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.serve.engine import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    card = smi()
    line("setup", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         card=card, allow_tf32={"matmul": False, "cudnn": False})

    marks = [time.perf_counter()]

    def mark(phase: str):
        """Print the seconds the phase took since the previous mark."""
        marks.append(time.perf_counter())
        laps.append(marks[-1])
        line("seconds", of=phase, seconds=round(marks[-1] - marks[-2], 3))

    laps = [marks[0]]

    def lap(part: str):
        """Print the seconds a part of a phase took since the previous lap or
        mark (``[seconds-part]``; the phase's ``[seconds]`` line holds it)."""
        laps.append(time.perf_counter())
        line("seconds-part", of=part, seconds=round(laps[-1] - laps[-2], 3))

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = common.build()
    build_s = time.perf_counter() - t0
    logs = [path.with_suffix(".log") for path in built.values()]
    # each kernel's entry line, then its registers, shared memory and spills
    ptxas = [ln.strip() for log in logs if log.exists() for ln in log.read_text().splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    # wkv_scan's design fits four blocks of 2K threads to an SM: at most 128
    # registers a thread (its __launch_bounds__), and a spill would put the
    # state tile in local memory
    wkv_regs = {n: e for n, e in ptxas_entries(ptxas).items() if "wkv_scan_kernel" in n}
    check(len(wkv_regs) == 6 and all(e["registers"] is not None and e["registers"] <= 128
                                     and e["spill_bytes"] == 0 for e in wkv_regs.values()),
          f"wkv_scan_kernel's registers or spills: {wkv_regs}")
    from repro_torch.kernels.attention import attention as ak
    from repro_torch.kernels.conv1x1 import conv1x1 as c1k
    from repro_torch.kernels.coupling import coupling as ck
    from repro_torch.kernels.rwkv import rwkv as rk
    from repro_torch.kernels.ssd import ssd as sk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gw_plans = {f"{c}, {t}": c1k.gw_plan(rows, c, es, n_sm) for rows, c in zip(
        (131072, 32768, 8192), c1k.STREAM_WIDTHS) for t, es in (("float", 4), ("bf16", 2))}
    spine_plans = {f"{c}, {t}": kern.spine_plan(rows, c, kern.spine_max_clusters(dev, dt, c))
                   for rows, c in zip((131072, 32768, 8192), kern.SPINE_WIDTHS)
                   for t, dt in (("float", torch.float32), ("bf16", torch.bfloat16))}
    line("build", seconds=round(build_s, 3), libraries=[str(p) for p in built.values()],
         ptxas=ptxas, card=card, dynamic_smem_bytes={
             **{f"flash_attention_tc_kernel<{d}>": ak.tc_smem_bytes(d) for d in (64, 128)},
             **{f"flash_attention_tf32_kernel<{d}>": ak.tf32_smem_bytes(d) for d in (32, 64, 128)},
             **{f"conv1x1_mm_stream_kernel<{t}, {c}>": c1k.stream_smem_bytes(c, es)
                for c in c1k.STREAM_WIDTHS for t, es in (("float", 4), ("bf16", 2))},
             **{f"conv1x1_gw_cluster_kernel<{k}> at the model's rows": c1k.gw_cluster_smem_bytes(
                 int(k.split(",")[0]), pl["xw"], pl["slab_rows"], 4 if "float" in k else 2,
                 pl["cluster_size"]) for k, pl in gw_plans.items()},
             **{f"ssd_{which}_kernel<{t}>": b for t, es in (("float", 4), ("bf16", 2))
                for which, b in sk.ssd_smem_bytes(es).items()},
             **{f"wkv_scan_kernel<{t}, {kd}>": rk.wkv_smem_bytes(kd, es)
                for kd in rk.HEAD_SIZES for t, es in (("float", 4), ("bf16", 2))},
             **{f"spine_bwd_cluster_kernel<{t}, {c}>": kern.spine_cluster_smem_bytes(
                 c, es, kern.SPINE_CLUSTER) for c in kern.SPINE_WIDTHS
                for t, es in (("float", 4), ("bf16", 2))},
             **{f"flowstep_{{fwd,inv}}_stream_kernel<{t}, {c}>": kern.flow_stream_smem_bytes(c, es)
                for c in kern.FLOW_PLAN for t, es in (("float", 4), ("bf16", 2))},
             **{f"coupling_rows_kernel<{t}, {c}>": ck.coupling_rows_smem_bytes(c, es)
                for c in c1k.STREAM_WIDTHS for t, es in (("float", 4), ("bf16", 2))},
             **{f"coupling_bwd_rows_kernel<{t}, {c}>": ck.coupling_bwd_rows_smem_bytes(c, es)
                for c in c1k.STREAM_WIDTHS for t, es in (("float", 4), ("bf16", 2))}},
         conv1x1_gw_plans=gw_plans, spine_bwd_plans=spine_plans)
    mark("build")

    # 2. kernels against their plain versions --------------------------------
    max_err = {"flowstep_fwd": 0.0, "flowstep_inv": 0.0}
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ls, ab, w, raw, t = step_inputs(shape, dtype, dev, SEED)
            path = kern.flowstep_path(x, raw, t)
            check(path == "stream", f"flowstep at {shape} {dtype} would take the {path} path")
            before = (dict(kern.flowstep_fwd.launches_by_path),
                      dict(kern.flowstep_inv.launches_by_path))
            y, ld = kern.flowstep_fwd(x, ls, ab, w, raw, t)
            y_r, ld_r = flowstep_fwd_ref(x, ls, ab, w, raw, t)
            y_again, ld_again = kern.flowstep_fwd(x, ls, ab, w, raw, t)
            w_inv = torch.linalg.inv(w)
            xb = kern.flowstep_inv(y_r, ls, ab, w_inv, raw, t)
            xb_r = flowstep_inv_ref(y_r, ls, ab, w_inv, raw, t)
            xb_again = kern.flowstep_inv(y_r, ls, ab, w_inv, raw, t)
            _, ld_k = flowstep_stream_ref(x, ls, ab, w, raw, t)
            torch.cuda.synchronize()
            check(kern.flowstep_fwd.launches_by_path["stream"] == before[0]["stream"] + 2
                  and kern.flowstep_inv.launches_by_path["stream"] == before[1]["stream"] + 2,
                  f"flowstep at {shape} {dtype} did not take the stream")
            err_y = (y.float() - y_r.float()).abs().max().item()
            err_x = (xb.float() - xb_r.float()).abs().max().item()
            err_ld = ((ld - ld_r).abs() / ld_r.abs().clamp_min(1.0)).max().item()
            err_ld_k = ((ld - ld_k).abs() / ld_k.abs().clamp_min(1.0)).max().item()
            if dtype == torch.float32:
                check(err_y <= TOL_F32 and err_x <= TOL_F32, f"f32 {shape}: y {err_y}, x {err_x}")
                max_err["flowstep_fwd"] = max(max_err["flowstep_fwd"], err_y)
                max_err["flowstep_inv"] = max(max_err["flowstep_inv"], err_x)
            else:
                for a, r, what in ((y, y_r, "y"), (xb, xb_r, "x")):
                    bad = (a.float() - r.float()).abs() > TOL_BF16 + TOL_BF16 * r.float().abs()
                    check(not bad.any().item(), f"bf16 {shape}: {what}")
            check(err_ld <= TOL_LD_REL and err_ld_k <= TOL_LD_REL,
                  f"ld {shape} {dtype}: {err_ld} (plain), {err_ld_k} (kernel order)")
            check(torch.equal(ld, ld_again) and torch.equal(y, y_again)
                  and torch.equal(xb, xb_again),
                  f"y, ld or x not bitwise repeatable at {shape} {dtype}")
            line("kernels", shape=list(shape), dtype=str(dtype).removeprefix("torch."), path=path,
                 fwd_max_abs_err=err_y, inv_max_abs_err=err_x, ld_max_rel_err=err_ld,
                 ld_max_rel_err_vs_kernel_order=err_ld_k, bitwise_repeatable=True)
    # the tile kernel: raw and t two tensors, not the halves of one
    for dtype in (torch.float32, torch.bfloat16):
        x, ls, ab, w, raw, t = step_inputs(SHAPES[-1], dtype, dev, SEED)
        raw, t = raw.contiguous(), t.contiguous()
        check(kern.flowstep_path(x, raw, t) == "tile",
              "separate raw and t not sent to the tile path")
        before = (dict(kern.flowstep_fwd.launches_by_path),
                  dict(kern.flowstep_inv.launches_by_path))
        y, ld = kern.flowstep_fwd(x, ls, ab, w, raw, t)
        y_r, ld_r = flowstep_fwd_ref(x, ls, ab, w, raw, t)
        w_inv = torch.linalg.inv(w)
        xb = kern.flowstep_inv(y_r, ls, ab, w_inv, raw, t)
        xb_r = flowstep_inv_ref(y_r, ls, ab, w_inv, raw, t)
        torch.cuda.synchronize()
        check(kern.flowstep_fwd.launches_by_path["tile"] == before[0]["tile"] + 1
              and kern.flowstep_inv.launches_by_path["tile"] == before[1]["tile"] + 1,
              "flowstep did not take the tile path")
        err_y = (y.float() - y_r.float()).abs().max().item()
        err_x = (xb.float() - xb_r.float()).abs().max().item()
        err_ld = ((ld - ld_r).abs() / ld_r.abs().clamp_min(1.0)).max().item()
        if dtype == torch.float32:
            check(err_y <= TOL_F32 and err_x <= TOL_F32, f"tile path f32: y {err_y}, x {err_x}")
        else:
            for a, r, what in ((y, y_r, "y"), (xb, xb_r, "x")):
                bad = (a.float() - r.float()).abs() > TOL_BF16 + TOL_BF16 * r.float().abs()
                check(not bad.any().item(), f"tile path bf16: {what}")
        check(err_ld <= TOL_LD_REL, f"tile path ld {dtype}: {err_ld}")
        line("kernels", shape=list(SHAPES[-1]), dtype=str(dtype).removeprefix("torch."),
             path="tile", fwd_max_abs_err=err_y, inv_max_abs_err=err_x, ld_max_rel_err=err_ld)
    lap("kernels: flowstep")
    max_err.update(check_bwd_kernels(dev))
    max_err.update(check_unrolled_kernels(dev))
    lap("kernels: backward and unrolled")
    attn_errs = check_attention_kernel(dev)
    max_err["flash_attention"] = attn_errs[(ATTN_SHAPES[3], "bfloat16")]
    lap("kernels: attention checks")
    attn_times = time_attention(dev)
    lap("kernels: attention times")
    max_err.update(check_scan_kernels(dev))
    check_kernel_guards(dev)
    lap("kernels: scan checks and guards")
    scan_times = time_scans(dev)
    mark("kernels")

    # 3. serve the model on the card ------------------------------------------
    flow_cpu = build_flow(GLOW_SCANNED, channels=3, generator=torch.Generator().manual_seed(SEED),
                          device="cpu")
    perturb(flow_cpu, SEED + 1)
    engine = FlowServeEngine(copy.deepcopy(flow_cpu), device="cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    x_cpu = torch.rand((BATCH, HW, HW, 3), generator=g) - 0.5  # images scaled to [-0.5, 0.5)
    x = x_cpu.to(dev)

    reset(kern.KERNELS)
    lp = engine.log_prob(x)
    torch.cuda.synchronize()
    launches = {"flowstep_fwd": kern.flowstep_fwd.launches}
    by_path = {"log_prob": dict(kern.flowstep_fwd.launches_by_path)}
    check(kern.flowstep_fwd.launches == 24 and kern.flowstep_inv.launches == 0,
          f"log_prob launches: {kern.KERNELS}")
    check(by_path["log_prob"] == {"stream": 24, "tile": 0},
          f"log_prob flowstep_fwd paths: {by_path['log_prob']}")

    lp_cpu = FlowServeEngine(flow_cpu, device="cpu").log_prob(x_cpu)
    rel = ((lp.cpu() - lp_cpu).abs() / lp_cpu.abs()).max().item()
    check(torch.isfinite(lp).all().item() and rel <= TOL_LOG_PROB, f"log_prob vs cpu: {rel}")

    with torch.inference_mode():
        z_data, _ = engine.flow(x)
    like = tuple(torch.empty_like(v, device="meta") for v in z_data)
    reset(kern.KERNELS)
    samples = engine.sample(torch.Generator().manual_seed(SEED + 3), like)
    torch.cuda.synchronize()
    launches["flowstep_inv"] = kern.flowstep_inv.launches
    by_path["sample"] = dict(kern.flowstep_inv.launches_by_path)
    check(kern.flowstep_inv.launches == 24 and kern.flowstep_fwd.launches == 0,
          f"sample launches: {kern.KERNELS}")
    check(by_path["sample"] == {"stream": 24, "tile": 0},
          f"sample flowstep_inv paths: {by_path['sample']}")

    lp_s = engine.log_prob(samples)
    z = std_normal_sample(derive_key(torch.Generator().manual_seed(SEED + 3), 0, dev), like)
    with torch.inference_mode():
        z_back, _ = engine.flow(samples)
    rt = max((a - b).abs().max().item() for a, b in zip(z_back, z))
    check(torch.isfinite(samples).all().item() and torch.isfinite(lp_s).all().item(),
          "samples or their log_prob not finite")
    check(rt <= TOL_ROUND_TRIP, f"forward(inverse(z)) vs z: {rt}")
    line("serve", image=[BATCH, HW, HW, 3], log_prob_mean=lp.mean().item(),
         log_prob_rel_err_vs_cpu=rel, sample_shape=list(samples.shape),
         sample_log_prob_mean=lp_s.mean().item(), round_trip_max_abs_err=rt,
         launches={"log_prob": {"flowstep_fwd": launches["flowstep_fwd"]},
                   "sample": {"flowstep_inv": launches["flowstep_inv"]}},
         launches_by_path=by_path)

    coupled = coupled_serve_phase(dev, card, x_cpu)
    launches.update(coupled["launches"])
    mark("serve")

    # 4. train, 5. memory and 6. the 1x1-conv op --------------------------------
    train = train_phase(dev, card)
    launches.update({k: train["launches"][k] for k in ("spine_bwd", "coupling_bwd")})
    memory_phase(dev, card)
    coupled_train = coupled_train_phase(dev, card)
    launches.update(conv1x1_op_phase(dev, card))
    mark("train, memory, op")

    # 5b. cHINT amortized posteriors: train step, sampling, restart, recipe
    chint = chint_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("chint")

    # 5d. the examples, the port's entry points; then 5c. the zoo and the UQ
    # layer (RealNVP, hyperbolic, scenarios, launchers), on 5d's seismic run
    ex_scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    try:
        examples = examples_phase(dev, card, ex_scratch)
        gc.collect()
        torch.cuda.empty_cache()
        mark("examples")
        uq = uq_phase(dev, card, examples["seismic"])
    finally:
        shutil.rmtree(ex_scratch, ignore_errors=True)
    del examples["seismic"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("uq")

    # 7. times -----------------------------------------------------------------
    per_shape = time_flow_kernels(dev)
    lap("times: flow kernels")

    gen = torch.Generator().manual_seed(SEED + 4)

    def train_step_of(run):
        params = dict(run["flow"].named_parameters())
        opt = adamw_init(params)

        def train_step():
            loss, grads = value_and_grad_nll(run["flow"], run["x"])
            adamw_update(params, grads, opt, TrainConfig(), 1e-5)
            return loss

        return train_step

    c_engine = coupled["engine"]
    for model, what, fn in (
            ("GLOW_SCANNED", "log_prob", lambda: engine.log_prob(x)),
            ("GLOW_SCANNED", "sample", lambda: engine.sample(gen, like)),
            ("GLOW_SCANNED", "train_step", train_step_of(train)),
            ("GLOW_COUPLED", "log_prob", lambda: c_engine.log_prob(coupled["x"])),
            ("GLOW_COUPLED", "sample", lambda: c_engine.sample(gen, coupled["like"])),
            ("GLOW_COUPLED", "train_step", train_step_of(coupled_train))):
        # 9 calls each (15 until the examples needed the time)
        median, runs_ms = e2e_wall_ms(fn, reps=9)
        q = sorted(runs_ms)
        line("times", model=model, e2e=what, batch=BATCH, median_ms=median, q1_ms=q[len(q) // 4],
             q3_ms=q[(3 * len(q)) // 4], runs_ms=runs_ms,
             images_per_s=BATCH / (median * 1e-3), card=card)
        # one profiled call: device time by the PyTorch op (or kernel wrapper)
        # that launched it; the idle share is against the unprofiled median
        busy_ms, idle, events = profile_call(fn, median, f"{model.lower()}_{what}")
        by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                        if not _is_device_event(e) and e.self_device_time_total > 0),
                       key=lambda r: -r[1])
        cat_launches = sum(e.count for e in events if e.key == "aten::cat")
        line("profile", model=model, call=what, device_busy_ms=busy_ms, unprofiled_median_ms=median,
             device_idle_share=idle, aten_cat_launches=cat_launches,
             device_ms_by_op=[[k, round(v, 4), n] for k, v, n in by_op[:12]])

    mark("times")

    # 8. the language model: the flash kernel's op, yi-6b served, their times
    launches.update(attention_op_phase(dev, card))
    per_shape["flash_attention"] = attn_times
    lm_times(lm_serve_phase(dev, card), card, e2e_wall_ms)
    gc.collect()
    torch.cuda.empty_cache()
    mark("yi-6b")

    # 9. the SSM language models, one at a time: each is freed before the next
    per_shape.update(scan_times)
    for arch in ("rwkv6-7b", "zamba2-7b"):
        served = ssm_serve_phase(dev, card, arch)
        launches["wkv_scan" if arch == "rwkv6-7b" else "ssd_scan"] = served["launches"]
        lm_times(served, card, e2e_wall_ms, name=arch)
        del served
        gc.collect()
        torch.cuda.empty_cache()
        mark(arch)

    # 10. the rest of the dense family and the MoE family, one model at a time
    lm_family_launches = lm_family_serve_phase(dev, card, e2e_wall_ms)
    mark("dense and MoE LMs")

    # 11. LM training: card against CPU, full size, memory, launcher, guard
    lm_train_vs_cpu(dev, card)
    lap("lm-train (a)")
    lm_train_flash_per_step, lm_train_peaks = lm_train_full(dev, card)
    lap("lm-train (b)")
    lm_train_memory(dev, card)
    lap("lm-train (c)")
    lm_train_launcher(dev, card)
    mark("lm-train")

    # 11, continued: rwkv6-7b and zamba2-7b trained through their plain scans
    ssm_train_vs_cpu(dev, card)
    lap("ssm-train (ssm-a)")
    ssm_train_restart(dev, card)
    lap("ssm-train (ssm-b)")
    ssm_train_memory(dev, card)
    mark("ssm-train")

    # 12. the front ends: whisper-small and llava-next-34b served and trained
    frontend_phase(dev, card, e2e_wall_ms)
    mark("front ends")

    # 13. distribution: two ranks on this card over gloo
    dist_launches = dist_phase(dev, card)
    mark("dist")

    # 14. model-sharded meshes: two ranks on this card over gloo; their
    # phase-15 parts run in the same ranks
    mesh_launches = mesh_phase(dev, card)
    mark("mesh")

    # 15. the dry run held against the card
    dryrun_launches = dryrun_phase(dev, card, mesh_launches["dryrun"], lm_train_peaks)
    mark("dryrun")

    def by_path(*names):
        """Each path's first ``[times]`` row of a kernel (its largest shape,
        f32 first where timed): shape, dtype and the times beside the bound."""
        out = {}
        for row in (r for n in names for r in per_shape.get(n, [])):
            path = row.get("path", "tile")
            if path not in out:
                out[path] = {k: row.get(k) for k in ("shape", "dtype", "ms", "plain_ms",
                                                     "bound_ms", "library_ms",
                                                     "f32_rate_bound_ms")
                             if row.get(k) is not None or k == "library_ms"}
        return out

    kernels = []
    # the couplings run on the row streams: their entries are the row op's,
    # at the model's (B, M, C)
    timed_as = {"coupling_fwd": "coupling_fwd_rows", "coupling_inv": "coupling_inv_rows",
                "coupling_bwd": "coupling_bwd_rows"}
    sources = {
        "flowstep_fwd": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:121"),
        "flowstep_inv": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:150"),
        "spine_bwd": ("flowstep.cu", "src/repro/kernels/flowstep/flowstep.py:171"),
        "coupling_bwd": ("coupling.cu", "src/repro/kernels/coupling/coupling.py:120"),
        "coupling_fwd": ("coupling.cu", "src/repro/kernels/coupling/coupling.py:95"),
        "coupling_inv": ("coupling.cu", "src/repro/kernels/coupling/coupling.py:151"),
        "conv1x1_mm": ("conv1x1.cu", "src/repro/kernels/conv1x1/conv1x1.py:70"),
        "conv1x1_gw": ("conv1x1.cu", "src/repro/kernels/conv1x1/conv1x1.py:46"),
        "flash_attention": ("attention.cu", "src/repro/kernels/attention/attention.py:80"),
        "ssd_scan": ("ssd.cu", "src/repro/kernels/ssd/ssd.py:81"),
        "wkv_scan": ("rwkv.cu", "src/repro/kernels/rwkv/rwkv.py:58"),
    }
    for name, (source, replaces) in sources.items():
        # the model's largest shape, in float32 (flash_attention: yi-6b's
        # prefill in bf16, the dtype the model serves in; wkv_scan and
        # ssd_scan: the prefill of rwkv6-7b and zamba2-7b, whose scans take
        # f32 inputs)
        main = per_shape[timed_as.get(name, name)][0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": max_err[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": bound_by(timed_as.get(name, name), tuple(main["shape"]),
                                 getattr(torch, main["dtype"])),
            "library_ms": main.get("library_ms"), "shape": main["shape"], "dtype": main["dtype"],
            "ms_from": main["ms_from"]["ms"], "path": main.get("path"),
            "by_path": by_path(name, timed_as.get(name, name)),
        })
        # phase 5d: the launches of each example's main on the card
        kernels[-1]["examples_launches"] = {what: n[name] for what, n in
                                            examples["launches"].items() if n.get(name)}
        if name == "flash_attention":
            # the LM serving paths of phase 10 and LM training (phase 11)
            # attend through the einsum path, as the reference's model does
            kernels[-1]["lm_generate_launches"] = lm_family_launches
            kernels[-1]["lm_train_step_launches"] = lm_train_flash_per_step
        if name in ("flowstep_fwd", "coupling_bwd", "spine_bwd", "flowstep_inv"):
            # phase 13: each rank's launches in a data-parallel step (two
            # ranks, 4 rows each) and in a sharded sample / log_prob call
            kernels[-1]["dist_launches_per_rank"] = {
                "dp_step": dist_launches["dp_step_per_rank"].get(name, 0),
                "sharded_log_prob": dist_launches["sharded_log_prob_per_rank"].get(name, 0),
                "sharded_sample": dist_launches["sharded_sample_per_rank"].get(name, 0)}
            # phase 14: each rank's launches in a model-sharded step (a (1, 2)
            # mesh, every leaf stored as the rank's block) and sample
            kernels[-1]["mesh_launches_per_rank"] = {
                "model_sharded_step": mesh_launches["step_per_rank"].get(name, 0),
                "model_sharded_sample": mesh_launches["sample_per_rank"].get(name, 0)}
        if name == "ssd_scan":
            # phase 15: a rank's launches per prefill of zamba2-7b at depth 7
            # on a (1, 2) mesh, beside the dry run's reckoning of that cell
            kernels[-1]["dryrun_prefill_launches_per_rank"] = dryrun_launches
        if name in chint["times"]:
            # the cHINT path: its launches a train step (coupling_bwd) or a
            # draw (coupling_inv), and the half kernel at its M = 1 shapes
            kernels[-1]["chint"] = {
                "launches_per_call": chint["launches"][name],
                "call": "train step" if name == "coupling_bwd" else "posterior draw",
                "by_shape": [{k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                  "library_ms", "row_op_ms")}
                             for row in chint["times"][name]]}
        if name in uq["times"]:
            # the UQ paths: launches per call on each, and the kernel at their
            # shapes (RealNVP's, the posterior stream's and the calibration's
            # M = 1, the image priors' 16x16)
            kernels[-1]["uq"] = {
                "launches_per_call": {call: n[name] for call, n in uq["launches"].items()
                                      if name in n},
                "by_shape": [{k: row[k] for k in ("shape", "call", "path", "ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                             for row in uq["times"][name]]}
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
