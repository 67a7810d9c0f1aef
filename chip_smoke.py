#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build    — nvcc every kernel source (src/repro_torch/kernels/csrc);
  2. kernels  — each hand-written kernel against its plain PyTorch version.
                Paged attention at full gemma2-2b width (H=8, K=4, hd=256,
                page=16, bf16 q; bf16 pools, and int8 and packed int4 pools
                with fp32 scales for the fused-dequant pair), then checked
                again at the main path's shapes and timed there beside its
                plain version, a one-call PyTorch yardstick
                (scaled_dot_product_attention on the gathered dense view,
                dequantized beforehand for a quantized pool; never called
                by the port) and its bound, with its launch plan
                (decode: n_split and the split and combine grids;
                prefill: its row tiles) and its achieved GB/s (decode) or
                TFLOP/s (prefill) per main-path layer. Flash attention at the
                whole-prompt path's shapes (S = 4096 and 8192, global and
                local layers, cap 0 and 50), then timed there beside its
                plain version, SDPA (is_causal where the window reaches
                every key) and its bound, per layer and as their mean,
                each layer's share of its bound printed. The weight-quantized
                matmuls (W8A16, W4A16, W8A8) at every (K, N) the quantized
                paths launch, ragged M and the main paths' rows (2, 8,
                2000, 4096), bf16 and fp32 x, per-channel and per-tensor
                scales (fp32 outputs within an fp32 ulp of the row's max
                per tensor-core step, W8A8's int32 products exact), then
                checked and timed on the same inputs at (2304 -> 9216),
                M = 8 and 4096, beside their plain versions, torch.matmul
                on the dequantized bf16 weight (torch._int_mm for W8A8, on
                x zero-padded to 24 rows at M = 8) and their bounds, and
                at M = 8 on every projection with each launch plan.
                Kernels and yardsticks are timed on the
                device (device_ms: a CUDA graph of the calls), the plain
                versions from the host (time_ms). Before the full-width
                phases: every attention kernel at hd 32 (1b), tiny
                gemma2-2b (1c) and tiny granite-moe (1d) served on the
                kernels, token-identical to generate; after them (2b) the
                paged pair and flash at granite-moe's geometry (hd 64,
                G = 3, decode GC = 1) checked and timed beside plain, SDPA
                and the bound;
  3. model    — full-width gemma2-2b (26 layers, random weights from a
                seed): one prefill_chunk_paged and decode_step_paged ticks
                through the kernels and through the plain walk, on copies
                of one pool, every kernel call also held against its plain
                version on its own inputs, logits compared where the
                model's own sensitivity to a rounding allows — on a bf16
                pool; one
                whole-prompt forward of 4096 tokens through flash
                attention and through its plain version; the chunk and
                ticks again on the mixed pool (int4 local layers, int8
                global ones); then with the weights stored at 8 and at 4
                bits (serving/quant.py), through dequant_dot's kernels
                against its plain version, and the bytes the stored
                weights hold against bf16;
  4. engine   — the main path: Engine.run built by repro_torch.launch.serve
                (derive_policy on h100-sxm, --max-batch 8, page 16, chunked
                prefill) over 8 prompts of 300-1200 tokens and one of 4200
                that crosses the 4096 window, 32 new tokens each, with the
                kernels' launch counts zeroed just before and read after;
                once on the bf16 pool (the two bf16 kernels launched, the
                quant pair not), once with --no-chunked-prefill (whole
                prompts padded to 4096 and 8192 rows: 26 flash launches per
                prefill and 26 paged decode launches per tick, no chunk
                kernel), once with --kv-policy {"sub0": 4, "sub1": 8} (the
                quant pair launched, the bf16 pair not), and once with the
                policy's quant_bits set to 4 (int4 FFN weights, int8
                attention projections: per decode tick and chunk 104 W8A16
                and 78 W4A16 launches, no W8A8);
  5. profile  — each of those traces again on a fresh engine under
                torch.profiler: device time by kernel and by row of the
                kernel table (a paged decode call's split and combine
                kernels summed under its row), device busy share;
  6. generate — the sequential entry point on 2 prompts of 1000 tokens, on
                2 prompts of 2560 tokens (flash prefill; launches counted),
                then on 1000 tokens through make_quant_dot's kernels (W4A16
                FFN in and gate, W8A8 FFN out, W8A16 lm_head; launches
                counted), and with W8A8 alone on FFN out through the
                kernel and through its plain version (token-identical);
  7. drift    — greedy_drift of the int8 and the mixed pool against the
                bf16 pool, teacher-forced through the kernels over one
                1000-token prompt and 32 steps (printed; only a non-finite
                value fails);
  8. haq      — (a) the HAQ search over the KV sites on h100-sxm (16
                episodes): bits within the sensitivity gate, within budget
                or at the gated floor, bytes per token and the roofline
                decode tick against bf16; then the main trace served by
                ``--kv-policy haq`` through the quant pair (and the bf16
                pair where a slot stays bf16); (b) HAQ's weight search
                over the 7 decode sites (10 episodes, so the agents
                train), each policy's ``Model.loss`` through the
                fake-quant hook on the card over a (1, 512) batch: losses
                finite, the best within budget or at the floor; (c)
                ``serve.main --autotune 32`` on 4 prompts of up to 256
                tokens, then ``--serving-config`` on its record: the
                paged kernels launched in calibration and validation,
                candidates, decode tok/s of the default and the winner,
                the Spearman rank correlation and the calibration scales;
  9. amc      — AMC (core/amc.py) on full-width gemma2-2b, then (its
                parameters freed) on full-width granite-moe-3b-a800m:
                target 0.5, 8 episodes, the greedy rollout and uniform
                keep 0.5, each policy's ratios, FLOPs fraction, loss
                (Model.loss on one (1, 4096) batch, flash in every layer)
                and seconds; pruned experts routed around;
 10. moe      — granite-moe served: phase 3's check, the main trace
                through the launcher (tok/s, ticks against gemma2-2b's,
                the dropped share of routed pairs per chunk, 0 at decode),
                its profile, and ``serve.main --arch granite-moe-3b-a800m
                --max-batch 8``;
 12. train    — after phase 10, every serving parameter freed: (a) the
                flash kernel's lse (within 2**-8 of the plain version's;
                ``out`` bit-identical with and without it) and the
                backward (models/flash.py: kernel forward, plain PyTorch
                backward) against autograd of the fp32 dense plain
                version, at B = 2, S = 4096: hd 256, G 2 global and local,
                cap 50 and 0; hd 64, G 3; the backward timed beside SDPA's
                forward and backward and its bound; (b) full-width
                gemma2-2b trained by ``python -m repro_torch.launch.train
                --batch 2 --seq 4096 --steps 8 --ckpt-every 0`` (remat on):
                26 x 2 flash launches a step and no other kernel, losses
                and grad norms finite, the last loss below the first; step
                time, tokens/s, peak memory and, over one more step, the
                device busy share; (c) one full-width step's gradients
                through the kernel against the plain flash path, per leaf,
                bounded by a control run (the plain path with the kernel's
                rounding as noise); (d) tiny gemma2-2b (S = 2048, flash at
                hd 32) trained 6 steps against 3 + checkpoint + restore +
                3, bit for bit;
 13. ssm      — after phase 12: (a) flash against its plain version at
                zamba2-1.2b's shared attention (B 2, S 4096, 32/32 heads of
                64: G = 1) and the NAS supernet's (S 2048, 8/4 heads of
                64, windows 0, 1024, 4096), timed beside plain, SDPA and
                the bound; (b) full-width mamba2-370m and zamba2-1.2b
                (random weights) served by ``generate``'s dense-cache
                branch on 2 prompts of 4096 tokens, 32 new tokens each:
                flash launched once per shared-block application (7 per
                zamba2 prefill, 0 for mamba2) and nothing else, the
                prefill's logits through the kernel against the plain flash
                path, tok/s, prefill and decode-step ms; (c) the
                reference's contract prefill(S) + decode_step ==
                forward(S+1) within 5e-2; (d) full-width gemma2-2b through
                ``make_prefill_step`` over 4608 tokens (ring caches) and 16
                ``make_serve_step`` decodes against ``decode_step_paged``
                through the paged kernel, teacher-forced, within
                LOGIT_RTOL;
 14. nas      — ``nas.search`` on the full 21-block backbone (8 warmup + 16
                search steps, data at B 2 x S 2048, the LUT on h100-sxm at
                B 8 x S 2048): flash launched once per attention op each
                forward sampled, losses and alpha finite, the derived arch
                and its latencies; each op's forward time at the LUT's
                shape beside the LUT's roofline value (printed);
 15. encdec   — after phase 14: (a) flash against its plain version at
                whisper-large-v3's geometry (20/20 heads of 64, G = 1):
                the encoder's bidirectional 16384 x 16384, the decoder's
                causal 2048, its cross attention 2048 x 16384 and a decode
                step's 1 x 16384, and at llava's (32/8 heads of 128, G = 4)
                causal 8192, then the paged decode at llava's heads over
                8192 keys, each timed beside plain, SDPA and the bound;
                (b) full-width whisper-large-v3 (32 + 32 layers, random
                weights) served by make_prefill_step on 16384 frames and a
                2048-token prompt and 16 greedy make_serve_step decodes:
                96 flash launches in the prefill and 32 a step, nothing
                else; then, with wq and wk times QK_SCALE (at the
                reference's init a bf16 ulp moves the logits by more than
                their size), the same path's logits against decode_fwd
                teacher-forced through the plain flash version, phase 3's
                rule; (c) trained by
                ``launch.train --arch whisper-large-v3 --batch 2 --seq
                4096 --steps 4`` (4096 frames, 512 decoder tokens): 32 x 2
                flash launches a step, losses and parameters finite (the
                random-init model's gradient norm overflows to inf, as the
                reference's does); step time, peak memory, busy share;
 16. vlm      — full-width llava-next-mistral-7b (32 layers, d 4096,
                7.24 B parameters, random weights): make_prefill_step on
                2048 patch rows and 6144 tokens (32 flash launches), then
                16 greedy steps through make_serve_step and through
                decode_step_paged over the identity page pool (32 paged
                decode launches a step): at the reference's init the paged
                run teacher-forced on the dense tokens, its first step's
                kernel calls held against the plain walk; with wq, wk
                times QK_SCALE both free, equal tokens; logits held under
                phase 3's rule both times; its training (AdamW at 16 bytes a
                parameter) would not fit one 80 GB card and is left to the
                CPU tests;
 17. mesh     — the sharded engine (serving/engine/sharded.py): the
                column-slice products of every local site against the
                slices of the whole products at the runs' rows (cuBLAS);
                (a) an NCCL world of 1 rank (launch.mesh.spawn) over the
                main trace through a model=1 mesh, tokens and every sampled
                logits row bit-identical to the unsharded engine's; (b),
                beside (a), a
                gloo world of 2 ranks on this card (gathers staged through
                host memory), model=2: full-width gemma2-2b cut to 2 of
                its 26 layers on a cut of the main trace (its first 2
                requests, 2 new tokens each, so a decode tick runs at
                most 2 live slots of 8) on the bf16 and the int8 pool and
                one 2048-token prompt whole through flash, each rank's
                pool K/2 heads, every rank's outputs equal, its first
                3 x 2 paged calls held per call, tokens and
                logits bit-identical to the unsharded engine's (which runs
                first in this process) where every local product equals
                its slice, else logits under LOGIT_RTOL; (c) tiny
                gemma2-2b at model=2 on the hd-32 kernels, bf16 and mixed
                pools, token-identical; each world's backend, each rank's
                parameter, pool, resident and peak memory against the
                unsharded engine's, tick times (host-staged, not a speed);
 18. mesh-train — training split over a mesh (training/sharded.py): (a)
                an NCCL world of 1 rank, full-width gemma2-2b, 2 steps of
                ``train(mesh=)`` at B 2 x S 4096, losses, grad norms and
                every leaf of the state bit-identical to the unsharded
                ``train()``; (b) a gloo world of 2 ranks on this card at
                data=2 (B 1 a rank), full-width gemma2-2b cut to 2 of its
                26 layers, with wq, wk times QK_SCALE, 2 steps under tests/test_torch_train_sharded
                .py's bf16 rules against the unsharded port in 2
                microbatches (the rows cut as the mesh cuts them) and,
                with that run as the control, against the plain unsharded
                port, masters sampled per leaf, each rank's state at rest
                half the
                whole's, its peak and seconds a step, 2 x 2 flash
                launches a step a rank; (c) tiny gemma2-2b at S = 2048
                (flash at hd 32) at model=2 and data=2 x model=2 (a gloo
                world of 4, beside (b)'s world), 3 steps under the same
                rules, the first
                through ``train(mesh=)``, which restores a whole
                checkpoint of the initial state, slicing it on each
                rank, and writes its own whole (checked bit for bit);
                then, in the same worlds, ``make_ac(mesh, "seq_tp")``
                beside dp from one state: whether the first loss and
                every gradient leaf but the norm scales are the same
                bits (printed), the norm scales' largest relative
                difference, 2 steps of each under the same rules; and
                the world of 4's second mesh, pod=2 x data=2: 2 steps at
                B 2 (the rows over data alone) and at B 1 (the sequence
                over data), each held whole over pod, the 4 ranks'
                metrics the same bits; under the same rules, B 2 against
                the one-device run in 2 microbatches, B 1 against the
                same row at data=2 in the world of 2 (its first loss the
                same bits), and both against the plain run, with the
                2-microbatch run and the run summing the two sequence
                blocks' bf16 gradients as the controls;
                (d) (b)'s state
                resharded onto one rank (``reshard_state``), its masters
                equal to (b)'s, and one step there bit-identical to the
                unsharded step from the same state; (e) in (b)'s world,
                one row of 4096 tokens at data=2, its sequence split
                over data (2048 rows a rank between sub-layers,
                ``DataSeqRows``), past ``train(mesh=)``'s layout check,
                2 steps from (b)'s initial state under the bf16 rules
                against the one-device run summing the two sequence
                blocks' bf16 gradients in fp32, and against the plain
                one-device run within them or twice that control's
                distance (both run on the card beside the world); each
                rank's peak, seconds a step and 2 x 2 flash launches a
                step over the whole sequence; (f) in (b)'s world, its
                second mesh pod=2 x data=1: one row of 4096 tokens at
                (b)'s cut, held whole over pod (each pod rank computes
                it, nothing sums over pod), past the layout check: the
                first loss and gradients and 2 steps, the pod ranks'
                losses, metrics and sampled gradients and masters the
                same bits, the first loss and gradients against the
                one-device run's (bit-identity printed), the steps under
                the bf16 rules against it; each rank's state at rest
                (half the whole's), peak, seconds a step and 2 x 2 flash
                launches a step;
 19. dryrun   — the dry-run (launch/dryrun.py, roofline/) on meta tensors:
                (a) the record of phase 12's step (full-width gemma2-2b,
                B 2 x S 4096, remat on, a mesh of one) beside phase 12's
                measured median step and peak: t_compute, t_memory, the
                bottleneck, model_flops, MFU (model_flops over the
                measured seconds x 989 TFLOP/s) and the predicted live
                peak over torch.cuda.max_memory_allocated (printed, not
                gated); (b) phase 18(b)'s measured per-rank state at rest
                against sharded_bytes_per_device for the same cut and
                mesh, equal to the byte; (c) ``python -m
                repro_torch.launch.dryrun --cells ... --mesh single`` in a
                subprocess started after phase 16 (one cell at a time;
                its cells trace on the host while phases 17-22 run,
                and it is collected after phase 22): the dense and moe
                families' cells and mamba2-370m decode_32k, zamba2-1.2b
                long_500k, whisper-large-v3 decode_32k and
                llava-next-mistral-7b train_4k, then gemma2-2b's and
                llama4-maverick-400b-a17b's decode_32k with --quant w4
                and with --quant haq; each cell's line printed, any
                refusal or failure fatal: 23 cells run (7 train, 16
                prefill and decode), then 2 and 2, then gemma2-2b's
                train_4k and prefill_32k with --ac-mode seq_tp, each
                printed beside its dp record (live peak, collective
                bytes, the three terms); and, in a second subprocess
                started after phase 1 at nice 19, train_4k on the
                two-pod mesh (--mesh multi) in microbatches below pod x
                data: gemma2-2b and granite-moe-3b-a800m at
                --microbatches 16 (16 rows over data alone) and
                gemma2-2b at 32 (8 rows, the sequence over data), each
                held whole over pod, 2 and 1 cells run, each record's
                live peak printed;
 20. mesh-serve — the sharded prefill and serve steps
                (training/sharded_serve.py): (a) an NCCL world of 1,
                full-width gemma2-2b, ``make_prefill_step(ac=)`` over B 2
                x 4096 (26 flash launches) and 4 ``make_serve_step(ac=)``
                steps, logits and every cache leaf bit-identical to the
                unsharded steps run first in the same process; (b) a gloo
                world of 2 on this card at model=2, full width cut to 2
                layers (wq, wk times QK_SCALE), the caches split on their
                sequence: prefill logits and each rank's blocks
                bit-identical to the unsharded run's where the column
                slices are (``cublas_slices``), 4 teacher-forced steps
                across the rings' wrap over caches grown to 4100 slots
                under LOGIT_RTOL, greedy tokens equal where the margin
                allows, each rank's cache bytes (half the whole's), peak
                and seconds a step (host-staged, not a speed); (c) tiny
                gemma2-2b at S 2048 in a gloo world of 4 at data=2 x
                model=2 and model=4 (``kv_span``), same rules, prefill
                bit for bit; (d) ``serve.main --tiny --autotune 8`` over
                the world of 2: the same winner on both ranks, its record
                served by ``--serving-config``, and a mesh_model=2
                candidate measured alike on both (``measure_candidate``);
                in (b)'s world, ``make_ac(mesh, "seq_tp")`` beside dp:
                the prefill over B 2 x 4096 bit-identical to dp's (logits
                and each rank's blocks), one train step of the same cut
                against dp's under phase 18's rules, each rank's peaks;
                (a) and (c) run beside (b)'s world;
 21. mesh-families — the ssm, hybrid, encoder-decoder and vision-stub
                families split over a mesh (training/sharded.py,
                training/sharded_serve.py): (a) an NCCL world of 1, every
                family at full width and depth: the sharded prefill on
                phases 13, 15 and 16's shapes at B 2 (mamba2 and zamba2
                4096 tokens; whisper 16384 frames and 2048 tokens; llava
                2048 patch rows and 6144 tokens) and 2 decode steps, and
                2 steps of ``train(mesh=)`` of mamba2, zamba2 and whisper
                at B 2 x S 4096, logits, caches, losses, grad norms and
                every leaf bit-identical to the unsharded runs in the
                same process; (b) a gloo world of 2 on this card at
                data=2 and at model=2, every width whole, mamba2 cut to 6
                of 48 layers, zamba2 to one hybrid group, whisper to 4 + 4
                of 32 + 32, llava to 4 of 32 (served only; wq, wk times
                QK_SCALE): prefill logits and each rank's blocks
                bit-identical to the unsharded run's (data=2: its rows';
                model=2: where the column slices are, ``cublas_slices``,
                else under LOGIT_RTOL), 2 teacher-forced steps under
                LOGIT_RTOL (whisper's cross attention over 8192 frames a
                rank through flash's lse and the combine), each rank's
                cache half the whole's; 2 train steps under phase 18's
                loss and grad-norm rules against the one-device run in as
                many microbatches as the mesh has data ranks; each rank's
                peak and seconds a step (host-staged, not a speed);
                zamba2's decode at model=2 printed beside the control of
                a bf16 ulp on a tenth of the one-device attention
                outputs; (c) tiny gemma2-2b in a gloo world of 6 at
                data=3 x model=2, B 1: the global layer's 9-slot cache
                split on its slots over data and its kv heads over model,
                the prefill's logits and blocks bit-identical to one
                device's, 4 decode steps over 15 slots under LOGIT_RTOL;
                then 2 train steps of one row of 2048 tokens (flash at hd
                32), which 3 divides in no dim, so data holds it whole:
                the 6 ranks' metrics and each data rank's sampled masters
                the same bits, the steps under phase 18's bf16 rules
                against the one-device run;
                (a) starts before phase 17 and runs beside its worlds, (b)
                starts after phase 18 and runs beside phases 19 and 20,
                (c) beside (b) after phase 20;
 22. moe-quant — the moe family over data ranks (models/moe.py's
                ``ranks``: the reference's global capacity, slots and
                aux loss) and stored and fake-quantized weights under a
                model split (``tp_dot``'s ``inner``): (a) an NCCL world
                of 1: granite-moe at full width cut to 8 of 32 layers, 2
                steps of ``train(mesh=)`` at B 2 x S 2048 bit-identical
                to ``train()``; full-width gemma2-2b on stored int8 and
                int4 weights, a B 2 x 1024 prefill and 2 decode steps
                through ``ShardedServeSteps`` bit-identical to the
                unsharded steps; and the one-device runs (b) is held to;
                (b) a gloo world of 2 on this card, depth cut to 2
                layers (wq, wk times QK_SCALE): granite-moe at data=2 at
                full width, ``moe_apply`` on B 2 x 4096 rows (global C
                2048, pairs dropped): the ranks' routes, keep and
                global slots equal to the one-device call's on the
                global rows (integers, exact), y within the kernel
                bound, aux the global scalar; the prefill's logits within
                LOGIT_RTOL of the one-device prefill of the global batch;
                2 train steps on uniform random tokens under phase 18's
                loss and grad-norm rules against the one-device run on
                the global batch; ``Model.loss`` on one row of 2048
                tokens, its sequence split over data: every rank's
                routes, keep and buffer rows equal to the one-device
                plan in every layer (integers), the loss within phase
                18's rule; gemma2-2b at model=2 on int8 and int4
                codes: W8A16/W4A16 launched on the ranks' column slices,
                each slice's call within the kernel bound of the whole
                call's columns and of its plain version on the slice
                (with both K-split plans printed), logits
                of the prefill and 2 steps under LOGIT_RTOL and greedy
                tokens equal where the margin allows, printed beside the
                one-device control of a bf16 ulp on a tenth of the
                attention outputs; one HAQ fake-quant
                training step (the per-channel scales over the whole
                weight, ``group_amax``) under phase 18's rules against
                one device; (a) starts once phase 21's world of 1 has
                ended and ends before phase 18, (b) runs after phase
                21, the card to itself;
 23. tables   — the paper's results on the card (src/repro_torch/tables/,
                examples/torch_*.py): (a) every section of
                ``python -m repro_torch.tables.run`` (Tables 1-7 and the
                roofline report) at the reference's sizes, each row printed
                under the card's name and power limit, every derived number
                finite, each HAQ best within its budget (or at the
                back-off's floor), each AMC best within its FLOPs target,
                Table 2's and Table 5's matrices and flags printed, not
                gated; (c) the four examples: torch_quickstart (tiny
                gemma2-2b: 30 steps, checkpoint, restore, generate: 7 x 4
                paged decode launches), torch_compress_pipeline at its
                settings (its stage 3 serving through the quant matmul
                kernels and the paged decode kernel, every launch counted
                and held to the policy's sites, its logits teacher-forced
                against the kernels' plain versions under phase 3's rule,
                the plain fake-quant hook's gap printed),
                torch_nas_specialize at P23_NAS_STEPS steps and
                torch_train_lm at P23_LM_STEPS (its loss falling); (a) and
                (c) run in a spawned child process beside phases 17-18,
                collected after phase 18; (b) after phase 22, the card to
                itself, Fig. 4 at full width: granite-3-8b's first six
                decode sites at M = 1, the bf16 product, W8A16 and W4A16
                timed on the device beside h100-sxm's roofline prediction,
                each kernel call held to its plain version (phase 2's
                bound);
 11. report   — one JSON line with every kernel's launches (flash's summed
                over phase 12's training run and phases 13-22's paths, the
                paged kernels' over the main trace, llava's paged steps,
                phase 17's sharded runs and phase 23's examples, the quant
                matmuls' over the engine's weight-quantized trace, phase
                22's sharded runs and phase 23's compress pipeline, summed
                over ranks), error, times.
Prints the card's name and power limit, one JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device or without the repository beside it.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version, fp32 of the bf16 outputs. Both compute in fp32
# and differ only in summation order (about 1e-6 of a row's scale), then
# round once to bf16, so an element may land one bf16 ulp apart: 2**-7 of
# |ref|. The absolute term covers elements near zero and is tied to the
# data: 2**-7 of the row's (one query head's hd values) max |ref|, one to
# two bf16 ulps of that max. A fixed bound would not do: softmax over n
# keys of N(0,1) scores gives |o| of about sqrt(e/n), 0.02-0.05 here.
RTOL = ROW_ATOL = 2.0 ** -7
# softcap cases scale q so that the scores (about N(0,1) after hd**-0.5)
# spread to about N(0, 20**2) and reach the cap; the plain version run
# without the cap must then miss the tolerance, else the case fails as
# one that does not test the cap
CAP_Q_SCALE = 20.0
# the quantized cases: the same tolerance. The kernel and its plain
# version dequantize each element to the same fp32 number (code * scale,
# one fp32 multiply) and then do the bf16 case's arithmetic.
# The main path's KV policy: int4 on the local layers (sub0), int8 on the
# global ones (sub1).
KV_POLICY = {"sub0": 4, "sub1": 8}
# a quantized scratch page is poisoned in its codes and its scales
POISON_CODE, POISON_SCALE = 127, 1e4
# full gemma2-2b attention width
H, K, HD, PAGE = 8, 4, 256, 16
WINDOW, CAP = 4096, 50.0
GEMMA = (H, K, HD)
# full granite-moe-3b-a800m attention: 24 query heads over 8 kv heads of
# width 64 (G = 3, so a decode split CTA serves GC = 1 query head); no
# softcap, every layer global
MOE_ARCH = "granite-moe-3b-a800m"
MOE_GEO = (24, 8, 64)
# kernels vs plain walk through 26 bf16 layers: each layer's attention
# output may differ by a bf16 ulp (2**-8 relative), and the residual
# stream carries it on through every later layer, so logits are held to 3%
# of the largest |logit| (about 8 bf16 ulps compounded), and must pick the
# same greedy token wherever the plain top-2 margin exceeds that.
LOGIT_RTOL = 0.03
GEN = 32


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


T_START = time.perf_counter()


def mark(what: str) -> None:
    """One line on stderr with the seconds since the script started, after
    each phase: where a cut run's time went shows at the end of its
    errors."""
    print(f"chip_smoke: {what} done at {time.perf_counter() - T_START:.1f} "
          f"s", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` called ``reps`` times back to back from the
    host, between CUDA events: the plain versions, whose host loops and
    host reads make them unfit for a CUDA graph. At tens of microseconds a
    call, the host sets this pace (see device_ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, arg_sets=((),), reps: int = 20, replays: int = 3) -> float:
    """Device ms of one ``fn(*args)``: ``reps`` calls, cycling through
    ``arg_sets``, captured once in a CUDA graph and replayed ``replays``
    times between CUDA events, so the host's launch cost is out of the
    measurement (back-to-back host calls of a 30-70 us kernel time the
    wrapper's Python). Give ``arg_sets`` several copies of inputs smaller
    than the 50 MB L2, so each call reads them from device memory as the
    main path does, not from the previous call's L2 lines."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up (builds, workspaces)
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


# ------------------------------------------------------------- kernels ----
def paged_case(seed, positions, Sq, n_blocks, bits=16, *, heads=(H, K),
               hd=HD, page=PAGE):
    """Random pools with a poisoned scratch page 0, a query chunk and a
    page table giving every sequence its own random pages (tails -> 0), at
    ``heads`` (query, kv) heads of width ``hd`` over pages of ``page``.
    ``bits`` 16: bf16 pools (pool_k, pool_v); 8 or 4: N(0,1) K/V quantized
    by the pool writers' mapping, (codes_k, scale_k, codes_v, scale_v),
    page 0's codes and scales poisoned. Returns the case with two queries:
    as drawn, and scaled for the softcap cases (``CAP_Q_SCALE``)."""
    import torch
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(positions)
    P = B * n_blocks + 1
    n_q, n_kv = heads
    pool_k = torch.randn((P, page, n_kv, hd), generator=g, device=dev)
    pool_v = torch.randn((P, page, n_kv, hd), generator=g, device=dev)
    if bits == 16:
        pool_k, pool_v = pool_k.bfloat16(), pool_v.bfloat16()
        pool_k[0], pool_v[0] = 37.0, -53.0     # a leak past the mask shows
        pools = (pool_k, pool_v)
    else:
        kq, ks = ref.quantize_kv(pool_k, bits)
        vq, vs = ref.quantize_kv(pool_v, bits)
        del pool_k, pool_v
        for t in (kq, vq):
            t[0] = POISON_CODE
        for t in (ks, vs):
            t[0] = POISON_SCALE
        pools = (kq, ks, vq, vs)
    q = torch.randn((B, Sq, n_q, hd), generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    pt = torch.zeros((B, n_blocks), dtype=torch.int32)
    for b, pos in enumerate(positions):
        need = min((pos + Sq - 1) // page + 1, n_blocks)
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    pos_t = torch.tensor(positions, dtype=torch.int32, device=dev)
    q_cap = (q.float() * CAP_Q_SCALE).bfloat16()
    return {0.0: q, CAP: q_cap}, pools, pt.to(dev), pos_t


def walk_span(pos, Sq, n_blocks, window):
    """[lo, hi] blocks a chunk at ``pos`` needs (the kernels' own range)."""
    hi = min((pos + Sq - 1) // PAGE, n_blocks - 1)
    lo = max((pos - window + 1) // PAGE, 0) if window else 0
    return lo, hi


def paged_work(positions, Sq, n_blocks, window, bits=16, geo=GEMMA):
    """(bytes, flops) the work these inputs need at heads and width ``geo``
    (H, K, hd): every live K/V page read once per kv head (``bits`` per
    stored element, and a quantized pool's 4-byte K and V scale per slot
    and kv head), q/table/positions read and the output written once;
    4*hd flops per valid (query head, key) pair."""
    H, K, HD = geo
    B = len(positions)
    per_slot = 2 * HD * bits // 8 + (8 if bits < 16 else 0)  # per kv head
    kv = 0
    valid = 0
    for pos in positions:
        lo, hi = walk_span(pos, Sq, n_blocks, window)
        kv += max(hi - lo + 1, 0) * PAGE * K * per_slot
        for s in range(Sq):
            qp = pos + s
            first = max(qp - window + 1, 0) if window else 0
            valid += max(min(qp, n_blocks * PAGE - 1) - first + 1, 0)
    io = 2 * B * Sq * H * HD * 2 + B * n_blocks * 4 + B * 4
    return kv + io, 4.0 * HD * valid * H


def bound_ms(positions, Sq, n_blocks, window, bits=16, geo=GEMMA):
    """Least time for ``paged_work``: its bytes over device memory or its
    flops over the bf16 peak, the larger. Returns (ms, 'bytes' |
    'operations')."""
    nbytes, flops = paged_work(positions, Sq, n_blocks, window, bits, geo)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_plan(is_dec, B, Sq, n_blocks, geo=GEMMA):
    """The launch plan of a paged kernel at these shapes, as the wrapper
    makes it: decode's split count and grids, prefill's row tiles."""
    from repro_torch.kernels import paged_attention as pa
    H, K, _ = geo
    if is_dec:
        g = pa.decode_grid(B, H, K, n_blocks, PAGE)
        return (f"n_split={g[2]}, split grid {g} = {g[0] * g[1] * g[2]} "
                f"CTAs, combine grid ({B}, {H})")
    g = pa.prefill_grid(B, Sq, H, K)
    return (f"{pa.PREFILL_ROWS}-row x {pa.PREFILL_TILE}-key tiles, grid "
            f"{g} = {g[0] * g[1] * g[2]} CTAs")


def dense_pools(pools, bits):
    """bf16 (pool_k, pool_v) holding what a case's pools hold: the pools
    themselves, or a quantized pool dequantized (for the SDPA yardstick,
    outside its timing)."""
    if bits == 16:
        return pools
    from repro_torch.kernels import ref
    kq, ks, vq, vs = pools
    return (ref.dequantize_kv(kq, ks, bits).bfloat16(),
            ref.dequantize_kv(vq, vs, bits).bfloat16())


def sdpa_yardstick(q, pool_k, pool_v, pt, positions, window):
    """One PyTorch call computing the same attention (without the softcap,
    which SDPA lacks) on the gathered dense view: the library_ms
    yardstick. The gather happens here, outside the timed call."""
    import torch
    import torch.nn.functional as F
    B, Sq = q.shape[:2]
    K, HD = pool_k.shape[-2:]
    n_blocks = pt.shape[1]
    T = n_blocks * PAGE
    k = pool_k[pt.long()].reshape(B, T, K, HD).transpose(1, 2)
    v = pool_v[pt.long()].reshape(B, T, K, HD).transpose(1, 2)
    qpos = positions.long()[:, None] + torch.arange(Sq, device=q.device)
    j = torch.arange(T, device=q.device)
    mask = j[None, None, :] <= qpos[:, :, None]
    if window:
        mask &= j[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def mismatch(got, want):
    """Elements of ``got`` outside the tolerance around ``want`` (fp32,
    hd last)."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() > ROW_ATOL * rowmax + RTOL * want.abs()


def check_kernel(name, fwd, plain, qs, pools, pt, pos, *, window, cap,
                 live_rows=None, bits=16):
    """Hold one kernel call against its plain version over the rows that
    are defined (``live_rows``: a padded chunk's rows past the table width
    are garbage by contract), and print the case. With a cap, the plain
    version without it must miss the tolerance. Returns max |err|."""
    import torch
    q = qs[cap]
    got = fwd(q, *pools, pt, pos, window=window, cap=cap)
    torch.cuda.synchronize()
    want = plain(q, *pools, pt, pos, window=window, cap=cap)
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output (bits={bits}, window={window}, "
             f"cap={cap})")
    g, w = got.float(), want.float()
    if live_rows is not None:
        g, w = g[:, :live_rows], w[:, :live_rows]
    err = float((g - w).abs().max())
    typical = float(w.abs().mean())
    shape = f"B={q.shape[0]} Sq={q.shape[1]}" + (
        f" n_blocks={pt.shape[1]}" if pt is not None else "")
    bad = mismatch(g, w)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max |err| {err:.4g}, "
             f"mean |ref| {typical:.4g} ({shape}, bits={bits}, "
             f"window={window}, cap={cap})")
    if cap:
        nocap = plain(q, *pools, pt, pos, window=window, cap=0.0).float()
        if live_rows is not None:
            nocap = nocap[:, :live_rows]
        if not mismatch(nocap, w).any():
            fail(f"{name}: without the softcap the plain version is within "
                 f"tolerance too ({shape}, bits={bits}, window={window}): "
                 f"the case does not test the cap")
    print(f"kernels: {name} {shape} bits={bits} window={window} cap={cap}: "
          f"max |err| {err:.4g} = {err / typical:.4g} x mean |ref| "
          f"({typical:.4g})", flush=True)
    return err


def kernel_specs():
    """name -> (kernel wrapper, plain version, pool bits it takes, decode?).
    Every callable takes (q (B, Sq, H, hd), *pools, pt, pos, ...)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    def dec(fn):
        return lambda q, *a, **kw: fn(q[:, 0], *a, **kw)[:, None]

    return {
        "paged_attention_fwd": (dec(pa.paged_attention_fwd),
                                dec(ref.paged_attention_ref), (16,), True),
        "paged_prefill_fwd": (pa.paged_prefill_fwd, ref.paged_prefill_ref,
                              (16,), False),
        "paged_attention_quant_fwd": (dec(pa.paged_attention_quant_fwd),
                                      dec(ref.paged_attention_quant_ref),
                                      (8, 4), True),
        "paged_prefill_quant_fwd": (pa.paged_prefill_quant_fwd,
                                    ref.paged_prefill_quant_ref, (8, 4),
                                    False),
    }


# (bits, window) of the layers the main path runs each kernel on: a global
# (window 0) and a local (window 4096) layer, bf16 for the bf16 pair; for
# the quant pair the KV_POLICY pool's int8 global and int4 local layers
MAIN_LAYERS = {"paged_attention_fwd": ((16, 0), (16, WINDOW)),
               "paged_prefill_fwd": ((16, 0), (16, WINDOW)),
               "paged_attention_quant_fwd": ((8, 0), (4, WINDOW)),
               "paged_prefill_quant_fwd": ((8, 0), (4, WINDOW))}


def phase_kernels(prefill_chunk: int, n_blocks_main: int):
    """Phase 2: every kernel against its plain version, then timed at the
    main path's shapes. Returns name -> partial kernel record."""
    import numpy as np
    import torch

    specs = kernel_specs()
    rng = np.random.default_rng(0)
    dec_pos = sorted([0, 17, 4095, 4097, 4999]
                     + rng.integers(1, 5000, 3).tolist())
    dec_blocks = -(-5000 // PAGE) + 1
    err = {name: 0.0 for name in specs}
    decode_cases = [
        # decode, B=8, ragged positions crossing the 4096 window
        (dec_pos, 1, dec_blocks, None)]
    prefill_cases = [
        # prefill, Sq=512 chunks at non-zero starts, one crossing the window
        ([1000, 4500], 512, 320, None),
        # padded final chunk running past the table width (40 blocks)
        ([512], 512, 40, 40 * PAGE - 512)]
    for i, (name, (fwd, plain, bit_set, is_dec)) in enumerate(specs.items()):
        for bits in bit_set:
            for c, (positions, Sq, n_blocks, live) in enumerate(
                    decode_cases if is_dec else prefill_cases):
                case = paged_case(100 + 10 * i + c, positions, Sq, n_blocks,
                                  bits)
                for window in (0, 64, WINDOW):
                    for cap in (0.0, CAP):
                        e = check_kernel(name, fwd, plain, *case,
                                         window=window, cap=cap,
                                         live_rows=live, bits=bits)
                        err[name] = max(err[name], e)
                del case

    # the main path's shapes, checked at every (bits, window) and then
    # timed on the same inputs at the main path's layers: a decode tick of
    # 8 ragged sequences, the long prompt's first full prefill chunk, and
    # (for the split between kernel and padding cost) a bf16 chunk of 2048
    # rows, not part of the kernels line
    timed = []
    for name, (_, _, bit_set, is_dec) in specs.items():
        if is_dec:
            timed.append((name, bit_set, dec_pos, 1,
                          max(n_blocks_main, dec_blocks)))
        else:
            timed.append((name, bit_set, [0], prefill_chunk, n_blocks_main))
            if prefill_chunk != 2048 and 16 in bit_set:
                timed.append((name, bit_set, [0], 2048, n_blocks_main))
    records = {}
    for name, bit_set, positions, Sq, n_blocks in timed:
        fwd, plain, _, is_dec = specs[name]
        ms = plain_ms = lib_ms = b_ms = 0.0
        rates = []
        for bits in bit_set:
            qs, pools, pt, pos = paged_case(7, positions, Sq, n_blocks, bits)
            q = qs[CAP]
            for window in (0, WINDOW):
                e = check_kernel(name, fwd, plain, qs, pools, pt, pos,
                                 window=window, cap=CAP, bits=bits)
                err[name] = max(err[name], e)
                if (bits, window) not in MAIN_LAYERS[name]:
                    continue              # checked, not on the main path
                t = device_ms(lambda: fwd(q, *pools, pt, pos, window=window,
                                          cap=CAP))
                ms += t / 2
                nbytes, flops = paged_work(positions, Sq, n_blocks, window,
                                           bits)
                rates.append(f"bits {bits} window {window} {t:.4f} ms = "
                             + (f"{nbytes / t / 1e6:.0f} GB/s of "
                                f"{HBM_BYTES_PER_S / 1e9:.0f}" if is_dec
                                else f"{flops / t / 1e9:.1f} TFLOP/s of "
                                f"{BF16_FLOPS / 1e12:.0f}"))
                plain_ms += time_ms(lambda: plain(q, *pools, pt, pos,
                                                  window=window, cap=CAP),
                                    reps=2, warmup=1) / 2
                lib_ms += device_ms(sdpa_yardstick(
                    q, *dense_pools(pools, bits), pt, pos, window),
                    reps=10) / 2
                t, by = bound_ms(positions, Sq, n_blocks, window, bits)
                b_ms += t / 2
            del qs, q, pools, pt, pos
        layers = ", ".join(f"bits {b} window {w}"
                           for b, w in MAIN_LAYERS[name])
        plan = paged_plan(is_dec, len(positions), Sq, n_blocks)
        print(f"kernels: {name} B={len(positions)} Sq={Sq} "
              f"n_blocks={n_blocks}, {plan}; {'; '.join(rates)}; mean of "
              f"{layers}: {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms by {by})", flush=True)
        if name not in records:
            records[name] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": by}
    for name in records:
        records[name]["max_abs_err"] = err[name]
    print(f"kernels: match plain versions (max |err| {json.dumps(err)}, "
          f"tolerance {ROW_ATOL:.4g}*max|ref row| + {RTOL:.4g}*|ref|)",
          flush=True)
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------ flash attention ----
# the whole-prompt main path's shapes: the engine pads short prompts to one
# 4096-row prefill chunk and the 4200-token prompt to 8192 rows
FLASH_S = (4096, 8192)
# (window, label) of the layers each whole-prompt forward runs: global and
# local (the 4096 window bites at 8192)
FLASH_LAYERS = ((0, "global"), (WINDOW, "local"))


def flash_case(seed, S, geo=GEMMA):
    """Full-width q (B=1, S, H heads), k, v (K kv heads) of width hd, bf16,
    from a seed (``geo`` = (H, K, hd), gemma2-2b's 8, 4, 256 by default):
    q as drawn and scaled for the softcap cases."""
    import torch
    H, K, HD = geo
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, S, H, HD), generator=g, device="cuda")
    k = torch.randn((1, S, K, HD), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, S, K, HD), generator=g, device="cuda").bfloat16()
    return {0.0: q.bfloat16(), CAP: (q * CAP_Q_SCALE).bfloat16()}, k, v


def flash_valid_pairs(S, window):
    """(query, key) pairs a causal layer over S tokens attends to: S(S+1)/2
    without a window, min(i + 1, window) summed over the rows with one."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound_ms(S, window, geo=GEMMA):
    """Least time for one call: q, k, v read and the output written once
    over device memory, or 4*hd flops per valid (query head, key) pair
    over the bf16 peak. Returns (ms, 'bytes' | 'operations')."""
    H, K, HD = geo
    t_bytes = 2 * (2 * S * H * HD + 2 * S * K * HD) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * HD * H * flash_valid_pairs(S, window) / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sdpa(q, k, v, window):
    """One PyTorch call computing the same attention without the softcap
    (SDPA has none): is_causal for a global layer and for a local one
    whose window reaches every key (window >= S: the same mask), a boolean
    mask otherwise. The library_ms yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window or window >= q.shape[1]:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_flash_kernels():
    """Phase 2, flash attention: the kernel against its plain version at
    the whole-prompt path's shapes (S = 4096 and 8192, global and local
    layers, cap 0 and 50 with the cap control), then timed on the same
    inputs at cap 50 beside the plain version, SDPA and the bound, per
    layer (with the layer's share of its bound) and as the
    mean of a global and a local layer, and printed. Returns the kernel
    record at S = 4096, the padded length of most prompts."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def fwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def plain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    err = 0.0
    rows = {}
    for S in FLASH_S:
        qs, k, v = flash_case(40 + S // 4096, S)
        for window, _ in FLASH_LAYERS:
            for cap in (0.0, CAP):
                err = max(err, check_kernel("flash_attention_fwd", fwd,
                                            plain, qs, (k, v), None, None,
                                            window=window, cap=cap))
                torch.cuda.empty_cache()
        q = qs[CAP]
        ms = plain_ms = lib_ms = b_ms = 0.0
        parts = []
        for window, label in FLASH_LAYERS:
            t = device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True, window=window, cap=CAP), reps=10)
            p = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window, cap=CAP), reps=2,
                warmup=1)
            torch.cuda.empty_cache()
            lib = device_ms(flash_sdpa(q, k, v, window), reps=10)
            bnd, by = flash_bound_ms(S, window)
            tflops = 4e-9 * HD * H * flash_valid_pairs(S, window) / t
            parts.append(f"{label} {t:.4f} ms ({tflops:.1f} TFLOP/s, "
                         f"{100 * bnd / t:.1f}% of its bound {bnd:.4f} ms; "
                         f"sdpa {lib:.4f} ms)")
            ms, plain_ms, lib_ms, b_ms = (ms + t / 2, plain_ms + p / 2,
                                          lib_ms + lib / 2, b_ms + bnd / 2)
        print(f"kernels: flash_attention_fwd B=1 S={S} H={H} K={K} hd={HD} "
              f"cap {CAP}: {'; '.join(parts)}; mean {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms by {by})", flush=True)
        rows[S] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": by}
        del qs, q, k, v
        torch.cuda.empty_cache()
    print(f"kernels: flash_attention_fwd matches its plain version (max "
          f"|err| {err:.4g}, tolerance {ROW_ATOL:.4g}*max|ref row| + "
          f"{RTOL:.4g}*|ref|)", flush=True)
    return dict(rows[FLASH_S[0]], max_abs_err=err)


# ---------------------------------------------------- quantized matmuls ----
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor-core peak
# (K, N) of every matmul the weight-quantized paths launch at gemma2-2b
# width: q, k/v, o, FFN in/gate, FFN out, and the lm_head of the hook path
QMM_SHAPES = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
              (9216, 2304), (2304, 256000))
QMM_RAGGED_M = (1, 5, 37, 1000)
# the rows the main paths give each shape: the engine's decode tick (8
# sequences) and prefill chunk (4096 rows) on every projection; generate's
# decode step (2 sequences) and prefill (2 x 1000 tokens, the lm_head
# unembedding all of them) on the FFN and the lm_head
LM_HEAD = (2304, 256000)
QMM_MAIN_M = {**{kn: (2, 8, 2000, 4096) for kn in QMM_SHAPES
                 if kn != LM_HEAD}, LM_HEAD: (2, 2000)}
QMM_TIMED = (2304, 9216)        # timed at M = 8 (decode) and 4096 (a chunk)
# bytes of weight copies the timed calls cycle through: four times the
# H100's 50 MB L2, as a decode tick streams 26 layers' weights past it
QMM_COLD_BYTES = 200 * 10 ** 6
INT_MM_MIN_ROWS = 24            # torch._int_mm needs more than 16 rows
# fp32 x through W8A16/W4A16: the kernel splits x into three bf16 terms
# (x = x0 + x1 + x2 exactly) whose products with the integer codes are
# exact, so what separates kernel and plain version is fp32 accumulation.
# The tensor cores' fp32 accumulation may drop up to an fp32 ulp of the
# running sum per mma step (it truncates), and there are 3 * K / 16 steps
# (three x terms, 16-deep steps), so such outputs are held to
# 3K/16 * 2**-23 of the row's max |ref| (5e-5 at K = 2304, 2e-4 at 9216).
# The plain version on x rounded to bf16 once (about 1e-3 of a typical
# output off) must miss that bound, else the case could not tell a kernel
# that drops x's low bits.
def fp32_row_atol(K: int) -> float:
    return 3 * K / 16 * 2.0 ** -23


def qmm_specs():
    """name -> (kernel wrapper, plain version, weight quantizer). Every
    callable takes (x, codes, scale) with x as the caller gives it; W8A8
    quantizes x per tensor first, as ops.quant_matmul does, and casts to
    x's dtype."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref

    def a8(fn):
        def call(x, codes, scale):
            xq, xs = ref.quantize_a8(x)
            return fn(xq, xs, codes, scale, out_dtype=x.dtype)
        return call

    return {
        "quant_matmul_w8a16": (qm.quant_matmul_w8a16,
                               ref.quant_matmul_w8a16, ref.quantize_w8),
        "quant_matmul_w4a16": (qm.quant_matmul_w4a16,
                               ref.quant_matmul_w4a16,
                               ref.quantize_w4_packed),
        "quant_matmul_w8a8": (a8(qm.quant_matmul_w8a8),
                              a8(ref.quant_matmul_w8a8), ref.quantize_w8),
    }


def fp32_mismatch(got, want, K):
    """Elements of ``got`` further than fp32_row_atol(K) of the row's max
    |want| from ``want`` (fp32, N last)."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() > fp32_row_atol(K) * rowmax


# fp32-x W8A16/W4A16 cases: the largest |err| / row max |ref| seen
FP32_SEEN = {}


def check_qmm(name, fwd, plain, x, codes, scale, what):
    """Hold one weight-quantized matmul against its plain version on x:
    bf16 outputs within the kernel tolerance; fp32 outputs of W8A16/W4A16
    within fp32_row_atol(K) of the row's max, which x rounded to bf16 must
    miss (the ratio err / row max is kept in ``FP32_SEEN``); fp32 outputs
    of W8A8 equal bit for bit (the int32 products exact). Returns max
    |err|."""
    import torch
    got = fwd(x, codes, scale)
    torch.cuda.synchronize()
    want = plain(x, codes, scale)
    M, K = x.shape
    N = codes.shape[1]
    if got.dtype != x.dtype or got.shape != (M, N) or \
            not torch.isfinite(got.float()).all():
        fail(f"{name}: bad output {got.dtype} {tuple(got.shape)} ({what})")
    gf, wf = got.float(), want.float()
    e = float((gf - wf).abs().max())
    fp32 = x.dtype == torch.float32
    if fp32 and name == "quant_matmul_w8a8":
        if not torch.equal(got, want):
            fail(f"{name}: fp32 output differs from the plain version's "
                 f"by up to {e:.4g} ({what}): the int32 products are not "
                 f"exact")
        return e
    if fp32:
        ratio = float(((gf - wf).abs() / wf.abs().amax(-1, keepdim=True))
                      .max())
        FP32_SEEN[name] = max(FP32_SEEN.get(name, 0.0), ratio)
    bad = fp32_mismatch(gf, wf, K) if fp32 else mismatch(gf, wf)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max |err| {e:.4g} "
             f"({what}, {'fp32 bound' if fp32 else 'bf16 bound'})")
    if fp32 and not fp32_mismatch(
            plain(x.bfloat16().float(), codes, scale), wf, K).any():
        fail(f"{name}: x rounded to bf16 stays within the fp32 bound "
             f"({what}): the case cannot see a kernel that drops x's low "
             f"bits")
    return e


def qmm_bound_ms(name, M, K, N):
    """Least time for one call: x, the stored codes, the scales and the
    bf16 output moved once over device memory, or 2*M*K*N operations over
    the bf16 (W8A16, W4A16) or int8 (W8A8) tensor-core peak."""
    code_bytes = K * N // 2 if name == "quant_matmul_w4a16" else K * N
    x_bytes = M * K * (1 if name == "quant_matmul_w8a8" else 2)
    t_bytes = (x_bytes + code_bytes + 4 * N + 4 + 2 * M * N) \
        / HBM_BYTES_PER_S * 1e3
    peak = INT8_OPS if name == "quant_matmul_w8a8" else BF16_FLOPS
    t_ops = 2.0 * M * K * N / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_call(name, x, codes, scale):
    """(kernel wrapper, plain version, arguments) of one timed call: W8A8
    takes x quantized beforehand, the others x as it is."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    if name != "quant_matmul_w8a8":
        return getattr(qm, name), getattr(ref, name), (x, codes, scale)
    xq, xs = ref.quantize_a8(x)
    return qm.quant_matmul_w8a8, ref.quant_matmul_w8a8, (xq, xs, codes,
                                                          scale)


def cold_weight_sets(args):
    """The call's arguments with distinct copies of its codes (the
    second-to-last argument), QMM_COLD_BYTES in all, so that each timed
    call reads its codes from device memory."""
    codes = args[-2]
    copies = max(1, -(-QMM_COLD_BYTES // codes.nbytes))
    return [args] + [args[:-2] + (codes.clone(), args[-1])
                     for _ in range(copies - 1)]


def qmm_library(name, x, codes, scale):
    """(fn, arg sets on cold weights, label) of the one-call PyTorch
    yardstick the port never calls: torch.matmul on the weight dequantized
    to bf16 beforehand (W8A16, W4A16), or torch._int_mm on x quantized
    beforehand and the codes as a column-major B (W8A8). _int_mm takes
    more than 16 rows: fewer are zero-padded to INT_MM_MIN_ROWS, and the
    label says so."""
    import torch
    from repro_torch.kernels import ref
    if name == "quant_matmul_w8a8":
        a, _ = ref.quantize_a8(x)
        label = "torch._int_mm"
        if a.shape[0] < INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros((INT_MM_MIN_ROWS - a.shape[0],
                                           a.shape[1]))])
            label += f" on x zero-padded to {INT_MM_MIN_ROWS} rows"
        b = codes.t().contiguous().t()
        fn = torch._int_mm
    else:
        unpacked = ref.unpack_w4(codes) if name == "quant_matmul_w4a16" \
            else codes
        a, b = x, (unpacked.float() * scale).bfloat16()
        fn, label = torch.matmul, "torch.matmul on bf16 weights"
    copies = max(1, -(-QMM_COLD_BYTES // b.nbytes))
    return fn, [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)], label


def phase_qmm_kernels():
    """Phase 2, the weight-quantized matmuls: each kernel against its
    plain version (``check_qmm``) at every (K, N) the paths launch, ragged
    M and the rows the main paths give that shape, bf16 and fp32 x,
    per-channel and per-tensor scales; then each checked again and timed
    on the same inputs at (2304 -> 9216), M = 8 and 4096, beside its plain
    version, a one-call PyTorch yardstick the port never calls and its
    bound. Returns name -> kernel record (the M = 4096 numbers) and prints
    both."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    specs = qmm_specs()
    err = {name: 0.0 for name in specs}
    g = torch.Generator(device="cuda").manual_seed(21)
    neg_pairs = 0
    for K, N in QMM_SHAPES:
        Ms = QMM_RAGGED_M + QMM_MAIN_M[(K, N)]
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        for name, (fwd, plain, quantize) in specs.items():
            codes, scale = quantize(w)
            if name == "quant_matmul_w4a16":
                # bytes whose two nibbles are both negative codes
                neg_pairs += int(((codes.to(torch.int16) & 0x88) == 0x88)
                                 .sum())
            for per_tensor in (False, True):
                s = scale.amax().reshape(1) if per_tensor else scale
                for M in Ms:
                    x = torch.randn((M, K), generator=g, device="cuda")
                    for dt in (torch.bfloat16, torch.float32):
                        e = check_qmm(name, fwd, plain, x.to(dt), codes, s,
                                      f"M={M}, K={K}, N={N}, {dt}, "
                                      f"per_tensor={per_tensor}")
                        err[name] = max(err[name], e)
                    del x
                    torch.cuda.empty_cache()
            del codes, scale
        print(f"kernels: quant matmuls (K={K}, N={N}) match plain at M "
              f"{Ms}, bf16/fp32 x, per-channel/per-tensor scales",
              flush=True)
        del w
        torch.cuda.empty_cache()
    if neg_pairs == 0:
        fail("quant_matmul_w4a16: no byte held two negative codes")
    print(f"kernels: W4A16 cases held {neg_pairs} bytes with both nibbles "
          f"negative; fp32 W8A16/W4A16 outputs within 3K/16 * 2**-23 x row "
          f"max |ref| (largest |err| / row max {json.dumps(FP32_SEEN)}; x "
          f"rounded to bf16 misses it); W8A8 fp32 outputs equal the plain "
          f"version's (exact int32 products)", flush=True)

    # checked, then timed, on the kernels' own inputs: W8A8 gets x
    # quantized beforehand
    K, N = QMM_TIMED
    records = {}
    w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    for name, (fwd, plain, quantize) in specs.items():
        codes, scale = quantize(w)
        row = {}
        for M in (8, 4096):
            x = torch.randn((M, K), generator=g,
                            device="cuda").bfloat16()
            what = f"timed inputs, M={M}, K={K}, N={N}"
            err[name] = max(err[name], check_qmm(name, fwd, plain, x, codes,
                                                 scale, what))
            kernel, plain_fn, args = qmm_call(name, x, codes, scale)
            if name == "quant_matmul_w8a8" and not torch.equal(
                    kernel(*args, out_dtype=torch.float32),
                    plain_fn(*args, out_dtype=torch.float32)):
                # the timed call's accumulator, exact: fp32 out bit for bit
                fail(f"{name}: fp32 output differs from the plain "
                     f"version's ({what}): the int32 products are not "
                     f"exact")
            ms = device_ms(kernel, cold_weight_sets(args))
            plain_ms = time_ms(lambda: plain_fn(*args), reps=5)
            lib_fn, lib_sets, lib_label = qmm_library(name, x, codes, scale)
            lib_ms = device_ms(lib_fn, lib_sets)
            del lib_sets
            b_ms, by = qmm_bound_ms(name, M, K, N)
            plan = qm.qmm_plan(M, N, K)
            print(f"kernels: {name} M={M} K={K} N={N}: {ms:.4f} ms (plain "
                  f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms "
                  f"[{lib_label}], bound {b_ms:.5f} ms by {by}; "
                  f"{2e-9 * M * K * N / ms:.1f} T(FL)OP/s; plan BT "
                  f"{plan['BT']} MT {plan['MT']} n_split {plan['n_split']} "
                  f"grid {plan['grid']})", flush=True)
            row[M] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library": lib_label, "bound_ms": b_ms,
                      "bound_by": by, "plan": plan}
            del x, args
        records[name] = dict(row[4096], max_abs_err=err[name],
                             decode=row[8])
        del codes, scale
    del w
    torch.cuda.empty_cache()

    # a decode tick (M = 8) on every projection: the wgmma kernels' launch
    # plans (K splits), two calls bit-identical (the reduces sum in a fixed
    # order), timed beside the library call, each call on cold weights
    for K, N in QMM_SHAPES:
        if (K, N) == LM_HEAD:
            continue
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        x = torch.randn((8, K), generator=g, device="cuda").bfloat16()
        for name, (fwd, plain, quantize) in specs.items():
            codes, scale = quantize(w)
            what = f"decode, M=8, K={K}, N={N}"
            err[name] = max(err[name], check_qmm(name, fwd, plain, x, codes,
                                                 scale, what))
            kernel, _, args = qmm_call(name, x, codes, scale)
            if not torch.equal(kernel(*args), kernel(*args)):
                fail(f"{name}: two calls differ ({what})")
            sets = cold_weight_sets(args)
            ms = device_ms(kernel, sets, max(20, min(len(sets), 200)))
            lib_fn, lib_sets, lib_label = qmm_library(name, x, codes, scale)
            lib_ms = device_ms(lib_fn, lib_sets,
                               max(20, min(len(lib_sets), 200)))
            b_ms, by = qmm_bound_ms(name, 8, K, N)
            plan = qm.qmm_plan(8, N, K)
            print(f"kernels: {name} M=8 K={K} N={N}: {ms:.4f} ms, plan BT "
                  f"{plan['BT']} MT {plan['MT']} n_split {plan['n_split']} "
                  f"grid {plan['grid']} (library {lib_ms:.4f} ms "
                  f"[{lib_label}], bound {b_ms:.5f} ms by {by})", flush=True)
            records[name].setdefault("decode_shapes", {})[f"{K}x{N}"] = {
                "ms": ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "n_split": plan["n_split"]}
            del codes, scale, args, sets, lib_sets
            torch.cuda.empty_cache()
        del w, x
    print(f"kernels: quant matmuls match plain versions (max |err| "
          f"{json.dumps(err)}; bf16 tolerance {ROW_ATOL:.4g}*max|ref row| + "
          f"{RTOL:.4g}*|ref|, fp32 3K/16*2**-23*max|ref row|)",
          flush=True)
    return records


KERNEL_SOURCES = {
    "paged_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:144"),
    "paged_prefill_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:323"),
    "paged_attention_quant_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:227"),
    "paged_prefill_quant_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:410"),
    "flash_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:88"),
    "quant_matmul_w8a16": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:47"),
    "quant_matmul_w4a16": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:94"),
    "quant_matmul_w8a8": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:141"),
}
# the device kernels each row of the kernel table launches, by name
# prefix in the profiler's key (anonymous namespaces dropped): a decode
# wrapper call is a split kernel and a combine kernel, summed under its row
DEVICE_ROWS = {
    "paged_attention_fwd": ("paged_decode_split_kernel<Bf16Pool",
                            "paged_decode_combine_kernel<Bf16Pool"),
    "paged_prefill_fwd": ("paged_prefill_kernel<Bf16Pool",),
    "paged_attention_quant_fwd": ("paged_decode_split_kernel<Int",
                                  "paged_decode_combine_kernel<Int"),
    "paged_prefill_quant_fwd": ("paged_prefill_kernel<Int",),
    "flash_attention_fwd": ("flash_fwd_kernel",),
    "quant matmuls": ("wq_kernel", "splitk_reduce_kernel", "w8a8_kernel",
                      "splitk_reduce_s32_kernel", "qmm_kernel"),
}
BF16_KERNELS = ("paged_attention_fwd", "paged_prefill_fwd")
QUANT_KERNELS = ("paged_attention_quant_fwd", "paged_prefill_quant_fwd")
# the whole-prompt main path (--no-chunked-prefill): flash attention in
# every prefill forward, the bf16 paged decode walk
WHOLE_KERNELS = ("flash_attention_fwd", "paged_attention_fwd")
# the engine's weight-quantized main path: stored int4 FFN weights and int8
# attention projections over the bf16 pool
WQ_KERNELS = BF16_KERNELS + ("quant_matmul_w8a16", "quant_matmul_w4a16")
WQ_BITS = 4
# the generate path through the HAQ dot hook's kernels: W4A16 on FFN in and
# gate, W8A8 on FFN out, W8A16 on the (tied) lm_head
GEN_QUANT_POLICY = {"ffn_in": (4, 16), "ffn_gate": (4, 16),
                    "ffn_out": (8, 8), "lm_head": (8, 16)}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict of parameters."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm
    pa.reset_launches()
    fa.reset_launches()
    qm.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm
    return {**pa.LAUNCHES, **fa.LAUNCHES, **qm.LAUNCHES}


def phase_model(model, params, kv_bits=None, ticks=1, w_bits=None,
                tag=""):
    """Phase 3: one chunk and ``ticks`` decode steps of the full-width
    model through the kernels and through the plain walk, on copies of one
    pool (bf16, or quantized under ``kv_bits``); returns the largest logit
    difference. With ``w_bits`` the parameters are stored at that width
    (serving/quant.py) and the two sides differ in the ``dot`` hook alone:
    the weight-quantized matmul kernels (``make_dequant_dot("cuda")``)
    against the plain dequantize-then-matmul (``"ref"``), both over the
    paged kernels. Every paged attention call of the kernel side is held
    against its plain version on the same inputs (``attention_calls``,
    the phase 2 tolerance), and the logits are held to LOGIT_RTOL where
    the model's own sensitivity allows it: the plain side run once more
    with a seeded tenth of each attention output moved by 2**-7 of its
    value (a bf16 ulp or two) gives the logit change such a rounding alone
    makes; where that exceeds
    the bound (random-weight granite-moe amplifies it to O(1) logits over
    32 layers), the logits are printed beside it and the per-call checks
    carry the comparison. A moe model's routing is shared
    (``shared_routing``): the plain side runs first and the others take
    its experts."""
    import torch
    from repro_torch.models.params import tree_map

    dev = params["embed"].device
    cfg = model.cfg
    if w_bits:
        from repro_torch.serving.quant import make_dequant_dot, \
            quantize_params
        bf16_bytes = tensor_bytes(params)
        params = quantize_params(params, default_bits=w_bits)
        torch.cuda.synchronize()
        label = f"model[{tag}w={w_bits}b]"
        print(f"{label}: parameters held {tensor_bytes(params) / 1e9:.4f} GB "
              f"against {bf16_bytes / 1e9:.4f} GB in bf16 "
              f"({tensor_bytes(params) / bf16_bytes:.4f}x), from the "
              f"tensors", flush=True)
        sides = {"cuda": {"kernel": "cuda", "dot": make_dequant_dot("cuda")},
                 "ref": {"kernel": "cuda", "dot": make_dequant_dot("ref")}}
    else:
        label = f"model[{tag}kv={kv_bits or 'bf16'}]"
        sides = {m: {"kernel": m, "dot": None} for m in ("cuda", "ref")}
    g = torch.Generator().manual_seed(3)
    B, C, n_blocks = 2, 512, 80
    pool = model.init_pool(B * n_blocks + 1, PAGE, device=dev,
                           kv_bits=kv_bits)
    pt = (torch.arange(B * n_blocks, dtype=torch.int32)
          .reshape(B, n_blocks) + 1).to(dev)
    toks = torch.randint(2, cfg.vocab_size, (B, 2 * C + ticks), generator=g,
                         dtype=torch.int32).to(dev)
    start = torch.zeros((B,), dtype=torch.int32, device=dev)
    model.prefill_chunk_paged(params, pool, pt, toks[:, :C], start,
                              **sides["cuda"])         # resident prefix
    logits = {}
    calls = {}
    with shared_routing(cfg) as replay:
        for run, mode, probe in (("ref", "ref", {}),
                                 ("cuda", "cuda", {"check": True}),
                                 ("ulp", "ref", {"perturb": True})):
            kw = sides[mode]
            replay(run != "ref")
            copy = tree_map(torch.clone, pool)
            with attention_calls(**probe) as calls[run]:
                hidden, _ = model.prefill_chunk_paged(
                    params, copy, pt, toks[:, C:2 * C], start + C, **kw)
                logits[run] = {"chunk": model.unembed(
                    params, hidden[:, -1:], dot=kw["dot"])}
                for t in range(ticks):
                    step, _ = model.decode_step_paged(
                        params, copy, pt, toks[:, 2 * C + t:2 * C + t + 1],
                        start + 2 * C + t, **kw)
                    logits[run][f"decode{t}" if ticks > 1 else "decode"] = \
                        step
            del copy
    checked = calls["cuda"]
    print(f"{label}: {checked['n']} paged attention calls of the kernel "
          f"side each within tolerance of the plain walk on its inputs "
          f"(max |err| {checked['err']:.4g})", flush=True)
    V = cfg.vocab_size          # the vocab-padding columns sit at -1e9
    err = 0.0
    for what in logits["ref"]:
        a, b, ulp = (logits[r][what][:, 0, :V]
                     for r in ("cuda", "ref", "ulp"))
        err = max(err, hold_logits(label, what, a, b, ulp))
    del logits, pool
    torch.cuda.empty_cache()
    return err


@contextlib.contextmanager
def shared_routing(cfg):
    """For a moe model, the experts each token is routed to, recorded in
    one run of calls and replayed in the next: yields ``replay(on)``,
    called before each run (off: record, on: replay). The replayed run
    takes the recorded experts (and so the same capacity drops) and
    recomputes their gates from its own probabilities. Routing is
    discrete: one bf16 ulp of attention output may tip a near-tie between
    two experts, or which pair a full expert drops, and so move a row's
    logits by far more than any kernel error; with the routing shared,
    kernels and plain walk are compared on the same experts. A dense
    model runs unchanged."""
    import torch
    from repro_torch.models import moe

    routes, state = [], {"replay": False, "i": 0}
    route = moe.route

    def shared(p, xf, mcfg):
        probs, gates, idx = route(p, xf, mcfg)
        if not state["replay"]:
            routes.append(idx)
            return probs, gates, idx
        idx = routes[state["i"]]
        state["i"] += 1
        gates = probs.gather(1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, idx

    def replay(on):
        state["replay"], state["i"] = on, 0

    if cfg.moe:
        moe.route = shared
    try:
        yield replay
    finally:
        moe.route = route
    if cfg.moe and state["i"] != len(routes):
        fail(f"shared routing: {len(routes)} routings recorded, "
             f"{state['i']} replayed")


PAGED_CALLS = ("paged_attention", "paged_attention_prefill",
               "paged_attention_quant", "paged_attention_prefill_quant")


@contextlib.contextmanager
def attention_calls(check=False, perturb=False, names=PAGED_CALLS,
                    limit=None):
    """The attention calls ``names`` of kernels/ops.py (by default the
    paged walks), wrapped for one run of calls. ``check``: each call that runs a kernel also runs its plain
    version on the same inputs and fails unless every element is within
    the phase 2 tolerance (``mismatch``); with ``limit``, only the first
    ``limit`` such calls. ``perturb``: each output comes
    back with a seeded tenth of its elements moved by 2**-7 of their value
    (a bf16 ulp or two: a rounding-sized change, for the model's own
    sensitivity). Yields
    {"n": calls checked, "err": largest |err|}."""
    import torch
    from repro_torch.kernels import ops as kops

    originals = {n: getattr(kops, n) for n in names}
    stats = {"n": 0, "err": 0.0}

    def wrap(name, fn):
        def call(*args, mode="auto", **kw):
            out = fn(*args, mode=mode, **kw)
            if check and out.is_cuda and mode != "ref" and (
                    limit is None or stats["n"] < limit):
                want = fn(*args, mode="ref", **kw).float()
                got = out.float()
                if mismatch(got, want).any():
                    fail(f"{name}: kernel call {stats['n']} off its plain "
                         f"version by up to "
                         f"{float((got - want).abs().max()):.4g}")
                stats["n"] += 1
                stats["err"] = max(stats["err"],
                                   float((got - want).abs().max()))
            if perturb:
                g = torch.Generator(device=out.device).manual_seed(
                    stats["n"])
                stats["n"] += 1
                hit = torch.rand(out.shape, generator=g,
                                 device=out.device) < 0.1
                sign = torch.randint(0, 2, out.shape, generator=g,
                                     device=out.device) * 2 - 1
                out = (out.float() * (1 + hit * sign * 2.0 ** -7)) \
                    .to(out.dtype)
            return out
        return call

    for n, fn in originals.items():
        setattr(kops, n, wrap(n, fn))
    try:
        yield stats
    finally:
        for n, fn in originals.items():
            setattr(kops, n, fn)


def compare_logits(label, what, a, b):
    """Kernel-path logits ``a`` against plain-path logits ``b`` (rows, V):
    within LOGIT_RTOL of the largest |b|, and the same greedy token
    wherever b's top-2 margin exceeds that. Returns max |a - b|."""
    import torch
    if not torch.isfinite(a).all():
        fail(f"{label} {what}: non-finite logits")
    d = float((a - b).abs().max())
    tol = LOGIT_RTOL * float(b.abs().max())
    top2 = torch.topk(b, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = a.argmax(-1) == b.argmax(-1)
    if d > tol or not bool((same | ~clear).all()):
        fail(f"{label} {what}: kernel vs plain logits differ by {d:.4g} "
             f"(tolerance {tol:.4g}), greedy tokens "
             f"{a.argmax(-1).tolist()} vs {b.argmax(-1).tolist()}")
    print(f"{label}: {what} logits kernel vs plain max |diff| {d:.4g} "
          f"(tolerance {tol:.4g}, |logit| up to "
          f"{float(b.abs().max()):.3g})", flush=True)
    return d


def hold_logits(label, what, a, b, ulp):
    """Kernel-path logits ``a`` against plain-path ``b`` (rows, V) with
    ``compare_logits``, unless the control ``ulp`` (the plain path with a
    bf16 ulp on a tenth of its attention outputs) already moves them past
    LOGIT_RTOL: then the model amplifies rounding past the bound, the
    per-call checks hold the kernel, and the difference is printed beside
    the control's (phase 3's rule)."""
    import torch
    d_ulp = float((ulp - b).abs().max())
    if d_ulp <= LOGIT_RTOL * float(b.abs().max()):
        return compare_logits(label, what, a, b)
    if not torch.isfinite(a).all():
        fail(f"{label} {what}: non-finite logits")
    d = float((a - b).abs().max())
    print(f"{label}: {what} logits kernel vs plain max |diff| {d:.4g}; a "
          f"bf16 ulp on a tenth of the plain path's attention outputs alone "
          f"moves them by {d_ulp:.4g} (|logit| up to "
          f"{float(b.abs().max()):.3g}, bound {LOGIT_RTOL}): the model "
          f"amplifies rounding past the bound, so the per-call checks hold "
          f"the kernel", flush=True)
    return d


def phase_model_whole(model, params, S=4096):
    """Phase 3, whole prompt: one full-width forward over S tokens with
    every layer's attention through flash_attention_fwd (kernel "cuda",
    one launch per layer counted) and through its plain version ("ref");
    the logits of rows spread over the prompt compared. Returns the
    largest logit difference."""
    import torch
    dev = params["embed"].device
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(2, model.cfg.vocab_size, (1, S), generator=g,
                         dtype=torch.int32).to(dev)
    rows = torch.tensor([0, 511, 2047, 2048, 3071, S - 1], device=dev)
    L = model.cfg.num_layers
    logits = {}
    for mode in ("cuda", "ref"):
        torch.cuda.synchronize()
        reset_all_launches()
        hidden, _, _, _ = model.forward(params, {"tokens": toks},
                                        unembed_mode="none", kernel=mode)
        n = all_launches()["flash_attention_fwd"]
        if n != (L if mode == "cuda" else 0):
            fail(f"model[whole-prompt]: kernel {mode!r} launched "
                 f"flash_attention_fwd {n} times over {L} layers")
        logits[mode] = model.unembed(params, hidden[:, rows])[0]
        del hidden
        torch.cuda.empty_cache()
    err = compare_logits(f"model[whole-prompt S={S}]",
                         f"rows {rows.tolist()}", logits["cuda"],
                         logits["ref"])
    print(f"model[whole-prompt S={S}]: {L} flash_attention_fwd launches per "
          f"forward", flush=True)
    return err


def main_trace(cfg):
    """8 prompts of 300-1200 tokens and one of 4200 (it crosses the 4096
    window of the local layers), GEN new tokens each."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(300, 1201, 8).tolist() + [4200]
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, S)
                    .astype(np.int32), max_new=GEN)
            for i, S in enumerate(lens)]


def phase_engine(model, params, extra_args=(), expect=BF16_KERNELS,
                 bf16_pages=None, quant_bits=None, bf16_summary=None,
                 tag=""):
    """Phase 4: the main path, through the launcher's own construction
    (``extra_args`` added to its command line; ``quant_bits`` overrides
    the derived policy's weight bits, as the reference's tests do). The
    kernels in ``expect`` must launch during the run and every other
    kernel must not; with quantized weights every decode tick and chunk
    launches W8A16 on the 4 attention projections and W4A16 on the 3 FFN
    matmuls of each layer; with --no-chunked-prefill every whole-prompt
    prefill launches flash attention once per layer. Returns (launches,
    policy, args, summary)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        ["--arch", model.cfg.name, "--max-batch", "8", "--page-size",
         str(PAGE), *extra_args])
    reqs = main_trace(model.cfg)
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    policy = serve.make_policy(model.cfg, model, args, max_len)
    if quant_bits:
        policy = dataclasses.replace(policy, quant_bits=quant_bits)
    label = f"engine[{tag}kv={policy.kv_bits or 'bf16'}, " \
        f"quant={policy.quant_bits}b]"
    print(f"{label}: admission[{args.hw}] max_batch={policy.max_batch} "
          f"prefill_chunk={policy.prefill_chunk} pages={policy.num_pages}"
          + (f" (bf16 policy: {bf16_pages} pages, "
             f"{policy.num_pages / bf16_pages:.2f}x)" if bf16_pages else "")
          + f" quant={policy.quant_bits}b"
          + f" max_model_len={policy.max_model_len}", flush=True)
    engine = serve.make_engine(model, params, policy, args)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    for r in reqs:
        o = outs[r.rid]
        if len(o) != len(r.prompt) + r.max_new:
            fail(f"{label}: request {r.rid} returned {len(o)} tokens, "
                 f"want {len(r.prompt) + r.max_new}")
        if not np.array_equal(o[:len(r.prompt)], r.prompt) or \
                o.min() < 0 or o.max() >= model.cfg.vocab_size:
            fail(f"{label}: request {r.rid} output malformed")
    for name, n in launches.items():
        if name in expect and n <= 0:
            fail(f"{label}: kernel {name} was never launched on the main "
                 f"path")
        if name not in expect and n:
            fail(f"{label}: kernel {name} was launched {n} times on a path "
                 f"that should not reach it")
    st = engine.stats
    ticks = engine.telemetry.ticks
    L = model.cfg.num_layers
    if not engine.chunked:
        # one flash launch per layer in each whole-prompt prefill, one
        # paged decode launch per layer in each decode tick
        n_pre = sum(t.kind == "prefill" for t in ticks)
        for name, per, n in (("flash_attention_fwd", "prefill", n_pre),
                             ("paged_attention_fwd", "decode tick",
                              st["decode_ticks"])):
            if launches[name] != L * n:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"want {L} per {per} ({n} of them)")
    if policy.quant_bits < 16:
        calls = st["decode_ticks"] + st["prefill_chunks"]
        for name, per_layer in (("quant_matmul_w8a16", 4),
                                ("quant_matmul_w4a16", 3)):
            if launches[name] != per_layer * L * calls:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"want {per_layer * L} per decode tick and chunk "
                     f"({calls} of them)")
    gen_total = st["decode_tokens"] + st["prefills"]
    kind = "chunk" if engine.chunked else "prefill"
    dec = [t.measured_s for t in ticks if t.kind == "decode"]
    pre = [t for t in ticks if t.kind == kind]
    rows = sum(t.q_len for t in pre)
    real = sum(t.tokens for t in pre)
    print(f"{label}: {kind} ticks ran {rows} query rows for {real} prompt "
          f"tokens: {100 * (1 - real / rows):.1f}% padding", flush=True)
    pre_ms = 1e3 * sum(t.measured_s for t in pre) / len(pre)
    by_len = {}
    for t in pre:
        by_len.setdefault(t.q_len, []).append(1e3 * t.measured_s)
    print(f"{label}: {kind} ticks by padded rows: " + ", ".join(
        f"{n} rows x{len(v)} mean {sum(v) / len(v):.3f} ms"
        for n, v in sorted(by_len.items())), flush=True)
    print(f"{label}: served {len(reqs)} requests, {gen_total} tokens in "
          f"{dt:.3f} s ({gen_total / dt:.2f} tok/s), "
          f"{st['decode_ticks']} decode ticks (mean "
          f"{1e3 * sum(dec) / len(dec):.3f} ms), {len(pre)} {kind} ticks "
          f"(mean {pre_ms:.3f} ms), {st['preemptions']} preemptions; "
          f"launches {json.dumps(launches)}", flush=True)
    summary = {"tok_s": gen_total / dt, "decode_ms": 1e3 * sum(dec) / len(dec),
               "prefill_ms": pre_ms}
    if bf16_summary:
        print(f"{label}: against gemma2-2b's bf16 run: "
              + ", ".join(f"{k} {summary[k]:.3f} vs {bf16_summary[k]:.3f}"
                          for k in summary), flush=True)
    return launches, policy, args, summary


def device_time_by_name(prof):
    """(kernel name -> device ms, device activities) of a finished
    torch.profiler run: its device-side activities' durations summed by
    name, as ``key_averages()`` sums them, read from the raw events (the
    per-event Python objects ``key_averages()`` builds first cost tens of
    seconds at 200k activities)."""
    by_name, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        key = e.name().replace("(anonymous namespace)::", "")
        by_name[key] = by_name.get(key, 0.0) + e.duration_ns() / 1e6
        n += 1
    return by_name, n


def phase_profile(model, params, policy, args, tag="", n_top=8,
                  n_requests=None):
    """Where the main path's device time goes: the same trace (or its
    first ``n_requests``) once more on a fresh engine under
    torch.profiler. Returns (kernel name -> device ms, device-busy ms,
    wall ms); device numbers are None when the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve

    engine = serve.make_engine(model, params, policy, args)
    reqs = main_trace(model.cfg)[:n_requests]
    label = f"profile[{tag}kv={policy.kv_bits or 'bf16'}, " \
        f"quant={policy.quant_bits}b]"
    torch.cuda.synchronize()
    # device activity only: host-op events would multiply the trace and
    # its post-processing without adding device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, launched = device_time_by_name(prof)
    busy = sum(by_name.values())
    if busy <= 0:
        print(f"{label}: the profiler saw no device time (not measured)",
              flush=True)
        return None, None, wall_ms
    rows = []
    for row, prefixes in DEVICE_ROWS.items():
        parts = [(k, v) for k, v in by_name.items()
                 if any(k.startswith(p) or f" {p}" in k for p in prefixes)]
        total = sum(v for _, v in parts)
        if total:
            rows.append(f"{row} {total:.1f} ms ({100 * total / busy:.1f}%)"
                        + (" = " + " + ".join(
                            f"{k.split('(')[0].removeprefix('void ')} "
                            f"{v:.1f}"
                            for k, v in parts) if len(parts) > 1 else ""))
    print(f"{label}: device time by kernel-table row: " + "; ".join(rows),
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    print(f"{label}: main path ({len(reqs)} requests) {wall_ms:.1f} ms "
          f"wall, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%), {launched} device "
          f"activities; top device time: "
          + "; ".join(f"{k[:80]} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in top), flush=True)
    return by_name, busy, wall_ms


def phase_generate(model, params):
    """Phase 5: the sequential entry point on the card."""
    import torch
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    t0 = time.perf_counter()
    out = generate(model, params, prompt, 16, page_size=PAGE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if out.shape != (2, 1016) or not torch.equal(out[:, :1000], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate: malformed output {tuple(out.shape)}")
    print(f"generate: 2 x 1000-token prompts + 16 tokens in {dt:.3f} s",
          flush=True)


def phase_generate_long(model, params, S=2560, gen=16):
    """Phase 6, long prompts: ``generate`` on 2 prompts of S tokens through
    the kernels, launches zeroed before and read after: its whole-prompt
    prefill launches flash_attention_fwd once per layer, each of its
    gen - 1 decode steps the paged decode kernel once per layer, and
    nothing else. Returns the launches."""
    import torch
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, S), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, gen, page_size=PAGE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    if out.shape != (2, S + gen) or not torch.equal(out[:, :S], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate[S={S}]: malformed output {tuple(out.shape)}")
    L = model.cfg.num_layers
    want = {"flash_attention_fwd": L, "paged_attention_fwd": L * (gen - 1)}
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"generate[S={S}]: {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    print(f"generate[S={S}]: 2 x {S}-token prompts + {gen} tokens in "
          f"{dt:.3f} s through the kernels; launches {json.dumps(launches)}",
          flush=True)
    return launches


def phase_generate_quant(model, params):
    """Phase 6, quantized: ``generate`` through the HAQ dot hook's kernels
    (``make_quant_dot(GEN_QUANT_POLICY, use_kernel=True)``) on 2 prompts of
    1000 tokens, launches zeroed before and read after: per forward (the
    prefill and each decode step) W4A16 on FFN in and gate and W8A8 on FFN
    out of every layer, and W8A16 on the lm_head. Returns the launches."""
    import torch
    from repro_torch.core.quantization import make_quant_dot
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    dot = make_quant_dot(GEN_QUANT_POLICY, use_kernel=True)
    gen = 16
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, gen, page_size=PAGE, dot=dot)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    if out.shape != (2, 1000 + gen) or not torch.equal(out[:, :1000], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate[quant]: malformed output {tuple(out.shape)}")
    L, forwards = model.cfg.num_layers, gen
    want = {"quant_matmul_w4a16": 2 * L * forwards,
            "quant_matmul_w8a8": L * forwards,
            "quant_matmul_w8a16": forwards}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"generate[quant]: {name} launched {launches[name]} times, "
                 f"want {n} ({forwards} forwards)")
    print(f"generate[quant]: 2 x 1000-token prompts + {gen} tokens through "
          f"{json.dumps(GEN_QUANT_POLICY)} in {dt:.3f} s; launches "
          f"{json.dumps(launches)}", flush=True)

    # W8A8 alone on FFN out, through the kernel and through its plain
    # version: the kernel's bf16 outputs equal the plain version's bit for
    # bit, so the generated tokens must be identical
    from repro_torch.kernels import ops as kops
    base = make_quant_dot({})

    def w8a8_only(mode):
        def site(x, w, name):
            if name == "ffn_out" and w.dim() == 2:
                return kops.quant_matmul(x, w, w_bits=8, a_bits=8, mode=mode)
            return base(x, w, name)
        return site

    toks = {}
    for mode in ("cuda", "ref"):
        reset_all_launches()
        toks[mode] = generate(model, params, prompt, gen, page_size=PAGE,
                              dot=w8a8_only(mode))
        torch.cuda.synchronize()
        n = all_launches()["quant_matmul_w8a8"]
        if n != (L * forwards if mode == "cuda" else 0):
            fail(f"generate[w8a8 {mode}]: W8A8 launched {n} times")
    if not torch.equal(toks["cuda"], toks["ref"]):
        fail("generate[w8a8]: the kernel's tokens differ from the plain "
             "version's")
    print(f"generate[w8a8]: W8A8 on FFN out through the kernel "
          f"({L * forwards} launches) and through its plain version: "
          f"{gen} tokens x 2 identical", flush=True)
    return launches


def phase_drift(model, params):
    """Phase 7: teacher-forced logit drift of the int8 and the KV_POLICY
    pool against the bf16 pool, through the kernels, over one 1000-token
    prompt and its 32-token greedy continuation. Printed, not gated: the
    weights are random, so the size of the drift says nothing about a
    trained model; only a non-finite value fails."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.serving.kvquant import greedy_drift, \
        teacher_forced_logits

    g = torch.Generator().manual_seed(11)
    prompt = torch.randint(2, model.cfg.vocab_size, (1, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    tokens = generate(model, params, prompt, GEN + 1,
                      page_size=PAGE)[0].cpu().numpy()
    t0 = time.perf_counter()
    fp = teacher_forced_logits(model, params, tokens, 1000, page_size=PAGE)
    for kv_bits in (8, KV_POLICY):
        rep = greedy_drift(model, params, tokens, 1000, kv_bits=kv_bits,
                           page_size=PAGE, fp_logits=fp)
        if not np.isfinite(rep["max_abs"]):
            fail(f"drift[kv={kv_bits}]: non-finite logits")
        print(f"drift[kv={json.dumps(kv_bits)}]: max |logit drift| "
              f"{rep['max_abs']:.4g} over {len(fp)} teacher-forced steps "
              f"(|logit| up to {float(np.abs(fp).max()):.3g}); greedy "
              f"flips at steps {rep['flip_steps']}; smallest bf16 top-2 "
              f"margin {float(rep['margins'].min()):.4g}", flush=True)
    print(f"drift: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------- HAQ search and autotuner --
# the autotune part's trace: 4 prompts of 4-256 tokens, 16 new tokens each
AUTOTUNE_ARGS = ["--arch", "gemma2-2b", "--requests", "4", "--prompt-len",
                 "256", "--gen", "16", "--max-batch", "8"]
AUTOTUNE_BUDGET = 32
WEIGHT_HAQ_EPISODES = 10    # the agents train at episode 10 (7 sites x 10
                            # transitions fill the 64-row replay batch)


def phase_haq_kv(model, params, bf16_pages, bf16_summary):
    """Phase 8a: the HAQ search over the full-width model's KV sites on
    h100-sxm (16 episodes), its bits checked against the sensitivity gate
    and the budget; then the main trace served through the launcher's
    own ``--kv-policy haq`` path (its 8-episode search), through the
    quant pair where every slot is quantized and both pairs where a slot
    stays bf16."""
    from repro_torch.core.haq import enumerate_kv_sites
    from repro_torch.core.hardware_model import H100_SXM
    from repro_torch.serving.kvquant import allowed_kv_bits, \
        search_kv_policy

    cfg = model.cfg
    max_len = max(len(r.prompt) + r.max_new for r in main_trace(cfg))
    t0 = time.perf_counter()
    res = search_kv_policy(cfg, H100_SXM, max_model_len=max_len,
                           episodes=16)
    dt = time.perf_counter() - t0
    sites = enumerate_kv_sites(cfg, 1, max_len)
    for s, b in zip(sites, res["bits"]):
        if b not in allowed_kv_bits(s):
            fail(f"haq[kv]: {s.name} searched to {b} bits, outside its "
                 f"gate {allowed_kv_bits(s)}")
    floor = tuple(min(allowed_kv_bits(s)) for s in sites)
    if res["resource"] > res["budget"] and res["bits"] != floor:
        fail(f"haq[kv]: {res['bits']} over budget ({res['resource']} > "
             f"{res['budget']}) with a slot above its gated floor {floor}")
    print(f"haq[kv]: searched bits {res['policy']} in {dt:.2f} s (16 "
          f"episodes, agent on the host); {res['kv_bytes_per_token']} "
          f"B/token against bf16's {res['kv_bytes_per_token_fp']} "
          f"({res['kv_bytes_per_token'] / res['kv_bytes_per_token_fp']:.4f}"
          f"x); roofline decode tick (h100-sxm, B=1, ctx {max_len}) "
          f"{1e3 * res['est_decode_s']:.6f} ms against bf16's "
          f"{1e3 * res['est_decode_s_fp']:.6f} ms; resident bytes "
          f"{res['resource']:.6g} against a budget of {res['budget']:.6g}",
          flush=True)
    launcher = search_kv_policy(cfg, H100_SXM, max_model_len=max_len,
                                episodes=8)["bits"]
    expect = QUANT_KERNELS if all(b < 16 for b in launcher) \
        else QUANT_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    _, policy, _, _ = phase_engine(
        model, params, ["--kv-policy", "haq"], expect=expect,
        bf16_pages=bf16_pages, bf16_summary=bf16_summary)
    if tuple(policy.kv_bits) != tuple(launcher):
        fail(f"haq[kv]: the launcher served kv={policy.kv_bits}, its "
             f"search gives {launcher}")
    print(f"haq[kv]: served on the searched pool {policy.kv_bits} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_haq_weights(model, params):
    """Phase 8b: HAQ's weight search on full-width gemma2-2b's 7 decode
    sites (batch 8) on h100-sxm, each policy scored by ``Model.loss``
    through the fake-quant hook on the card over one (1, 512) batch of
    random tokens from seed 0; losses finite, the best policy within the
    budget or at the all-minimum floor (the reference test's check)."""
    import math
    import torch
    from repro_torch.core import haq
    from repro_torch.core.hardware_model import H100_SXM
    from repro_torch.core.quantization import make_quant_dot

    cfg = model.cfg
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(2, cfg.vocab_size, (1, 512), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    batch = {"tokens": tokens, "labels": tokens}
    losses = []

    def eval_policy(policy):
        loss = float(model.loss(params, batch, dot=make_quant_dot(policy)))
        if not math.isfinite(loss):
            fail(f"haq[weights]: non-finite loss {loss} at {policy}")
        losses.append(loss)
        return loss

    t0 = time.perf_counter()
    bf16 = float(model.loss(params, batch))
    sites = haq.enumerate_sites(cfg, 8, 1, decode=True)
    res = haq.search(cfg, sites, eval_policy,
                     haq.HAQConfig(episodes=WEIGHT_HAQ_EPISODES),
                     hw=H100_SXM)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    best = res["best"]
    floor = haq.resource(sites, [(min(haq.W_BITS), min(haq.A_BITS))]
                         * len(sites), H100_SXM, "latency")
    if not (best["resource"] <= best["budget"] * (1 + 1e-12)
            or abs(best["resource"] - floor) <= 1e-12 * floor):
        fail(f"haq[weights]: best policy at {best['resource']} s over its "
             f"budget {best['budget']} s and above the floor {floor} s")
    agent = res["agents"][0]
    trained = agent.episode >= agent.cfg.warmup_episodes \
        and agent.buffer.n >= agent.cfg.batch
    print(f"haq[weights]: {len(losses)} policies scored in {dt:.1f} s "
          f"({WEIGHT_HAQ_EPISODES} episodes, {agent.buffer.n} transitions, "
          f"agents trained: {trained}); best {best['policy']}; "
          f"roofline latency {1e3 * best['resource']:.6f} ms against a "
          f"budget of {1e3 * best['budget']:.6f} ms (W8A8 "
          f"{1e3 * best['base_resource']:.6f} ms); loss "
          f"{best['loss']:.6f} against the bf16 model's {bf16:.6f} "
          f"(all sites 16 bits: {res['base_loss']:.6f}); episode losses "
          f"{[round(x, 4) for x in losses]}", flush=True)


def phase_autotune():
    """Phase 8c: ``serve.main --autotune`` on full-width gemma2-2b (the
    launcher builds its own model from seed 0), then ``--serving-config``
    on the record it wrote. Launches are counted over each call; the
    calibration and validation engines' launches are the first call's
    less the second's (both end by serving the winner on the same
    trace), and the paged kernels must be among them."""
    import torch
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as tmp:
        out_file = Path(tmp) / "serving.json"
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        serve.main(AUTOTUNE_ARGS + ["--autotune", str(AUTOTUNE_BUDGET),
                                    "--autotune-out", str(out_file)])
        torch.cuda.synchronize()
        tuned = all_launches()
        t1 = time.perf_counter()
        reset_all_launches()
        serve.main(AUTOTUNE_ARGS + ["--serving-config", str(out_file)])
        torch.cuda.synchronize()
        served = all_launches()
        t2 = time.perf_counter()
        record = json.loads(out_file.read_text())
    validation = {k: tuned[k] - served[k] for k in tuned}
    for names in (("paged_attention_fwd", "paged_attention_quant_fwd"),
                  ("paged_prefill_fwd", "paged_prefill_quant_fwd")):
        if sum(validation[k] for k in names) <= 0:
            fail(f"autotune: no launch of {names} during calibration and "
                 f"validation ({json.dumps(validation)})")
        if sum(served[k] for k in names) <= 0:
            fail(f"autotune: --serving-config never launched {names}")
    prov = record["provenance"]
    corr = prov["rank_correlation"]
    print(f"autotune: {prov['candidates']} candidates "
          f"({prov['admissible']} admissible), winner "
          f"{record['knobs']} kv_bits={record['kv_bits']}; measured "
          f"decode {prov['measured_decode_tok_s']:.3f} tok/s against the "
          f"default's {prov['default_decode_tok_s']:.3f} "
          f"({prov['searched_vs_default']:.4f}x); predicted "
          f"{prov['predicted_decode_tok_s']:.3f}; Spearman rank "
          f"correlation predicted vs measured: "
          + ("n/a (fewer than 3 measured or a constant side)"
             if corr is None else f"{corr:.4f}"), flush=True)
    cal = prov["calibration"]
    print(f"autotune: calibration kinds {sorted(cal['by_kind'])}, scales "
          f"by kind {json.dumps(cal['by_kind'])}, by shape "
          f"{json.dumps(cal['by_shape'])}", flush=True)
    print(f"autotune: launches in calibration and validation "
          f"{json.dumps(validation)}; --serving-config "
          f"{json.dumps(served)}; --autotune call {t1 - t0:.1f} s, "
          f"--serving-config call {t2 - t1:.1f} s", flush=True)


# ------------------------------------------------ tiny gemma2-2b (hd 32) --
# tiny gemma2-2b (the reference's tiny_config): 4 query heads, 2 kv heads of
# width 32, a local window of 32; served at pages of 16 and 64 (a page of 64
# spans two 32-key decode tiles), chunked and whole-prompt, and at a page of
# 48 chunked (tiles that start in the middle of a page); the kernels also
# checked at pages below, at and above the tiles, and at pages that neither
# divide a tile nor are a multiple of one (3, 24, 48, 96)
TINY_HEADS, TINY_HD, TINY_WINDOW = (4, 2), 32, 32
TINY_PAGES = (16, 64)
TINY_CHUNKED_PAGES = (48,)
TINY_KERNEL_PAGES = (2, 16, 64, 128, 3, 24, 48, 96, 256)
TINY_GEN = 16
TINY_MOE_PAGES = (16, 48)


def phase_tiny_kernels():
    """Phase 1b: every attention kernel at hd 32 against its plain version
    (tolerance as phase 2): decode and prefill over bf16, int8 and int4
    pools at pages below, at and above the 32-key decode tile and pages
    whose tiles start mid-page (TINY_KERNEL_PAGES), positions across the
    tiny window and page edges, windows {0, 32} and caps {0, 50}; flash
    over 2560 tokens. A failure ends the run."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    positions = [0, 31, 33, 64, 129, 300]
    for page in TINY_KERNEL_PAGES:
        for name, (fwd, plain, bit_set, is_dec) in kernel_specs().items():
            Sq = 1 if is_dec else 70
            n_blocks = (max(positions) + Sq) // page + 3
            for bits in bit_set:
                qs, pools, pt, pos = paged_case(
                    300 + page + bits, positions, Sq, n_blocks, bits,
                    heads=TINY_HEADS, hd=TINY_HD, page=page)
                for window in (0, TINY_WINDOW):
                    for cap in (0.0, CAP):
                        check_kernel(f"{name}[hd=32 page={page}]", fwd,
                                     plain, qs, pools, pt, pos,
                                     window=window, cap=cap, bits=bits)
    g = torch.Generator(device="cuda").manual_seed(17)
    S = 2560
    n_q, n_kv = TINY_HEADS
    q = torch.randn((1, S, n_q, TINY_HD), generator=g, device="cuda")
    k = torch.randn((1, S, n_kv, TINY_HD), generator=g,
                    device="cuda").bfloat16()
    v = torch.randn((1, S, n_kv, TINY_HD), generator=g,
                    device="cuda").bfloat16()
    qs = {0.0: q.bfloat16(), CAP: (q * CAP_Q_SCALE).bfloat16()}

    def fwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def plain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    for window in (0, TINY_WINDOW):
        for cap in (0.0, CAP):
            check_kernel("flash_attention_fwd[hd=32]", fwd, plain, qs,
                         (k, v), None, None, window=window, cap=cap)


def tiny_trace(cfg, whole: bool):
    """Chunked runs: 8 prompts of 40-100 tokens (past the window of 32 and
    page edges). Whole-prompt runs: 4 prompts of FLASH_MIN = 2048 tokens,
    so that the engine (which pads a prompt to its 2048-row bucket) and
    ``generate`` (which pads nothing) both prefill through flash on the
    same rows. TINY_GEN new tokens each."""
    import numpy as np
    from repro_torch.models.flash import FLASH_MIN
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(3)
    lens = [FLASH_MIN] * 4 if whole else rng.integers(40, 101, 8).tolist()
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, S)
                    .astype(np.int32), max_new=TINY_GEN)
            for i, S in enumerate(lens)]


def phase_tiny_engine(kv_policy_file):
    """Phase 1c: the north star's tiny main path on the card: tiny
    gemma2-2b served by the engine with ``--paged-kernel cuda`` at pages of
    16 and 64, chunked (32-token chunks) and whole-prompt (2048-token
    prompts, through flash), and at a page of 48 chunked, over a bf16 pool
    and the KV_POLICY pool (tiny_engine_run)."""
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.models.api import build_model

    model = build_model(tiny_config("gemma2-2b"))
    cfg = model.cfg
    if cfg.resolved_head_dim != TINY_HD or \
            (cfg.num_heads, cfg.num_kv_heads) != TINY_HEADS:
        fail(f"tiny gemma2-2b is not hd {TINY_HD}, heads {TINY_HEADS}")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    runs = list(itertools.product(TINY_PAGES, (True, False), (False, True)))
    runs += list(itertools.product(TINY_CHUNKED_PAGES, (True,),
                                   (False, True)))
    for page, chunked, kv in runs:
        tiny_engine_run(model, params, "gemma2-2b", page, chunked,
                        kv_policy_file if kv else None)


def phase_tiny_moe_engine():
    """Phase 1d: tiny granite-moe (the reference's tiny_config: hd 32, 4
    experts top 2 at capacity 4.0, drop-free) served through the kernels
    at pages of 16 and 48, chunked, on the bf16 pool (tiny_engine_run)."""
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.models.api import build_model

    model = build_model(tiny_config(MOE_ARCH))
    if model.cfg.resolved_head_dim != TINY_HD or \
            model.cfg.moe.capacity_factor != 4.0:
        fail(f"tiny {MOE_ARCH} is not hd {TINY_HD} at capacity 4.0")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    for page in TINY_MOE_PAGES:
        tiny_engine_run(model, params, MOE_ARCH, page, True, None)


def tiny_engine_run(model, params, arch, page, chunked, kv_policy_file):
    """One tiny run: the engine built by the launcher (``--tiny
    --paged-kernel cuda --page-size page``, 32-token chunks or whole
    prompts of 2048 tokens through flash, the KV_POLICY pool where
    ``kv_policy_file`` is given) must launch the attention kernels of its
    path (and no other), and give tokens identical to the port's own
    ``generate`` on each prompt: kernel "cuda", the same page size and
    pool (bf16, or the KV_POLICY bits quantized on write), prefilling as
    the run does (``generate``'s ``prefill_chunk``, or its whole-sequence
    forward)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve

    cfg = model.cfg
    reqs = tiny_trace(cfg, whole=not chunked)
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    argv = ["--arch", arch, "--tiny", "--paged-kernel", "cuda",
            "--page-size", str(page), "--max-batch", "8"]
    argv += ["--prefill-chunk", "32"] if chunked else \
        ["--no-chunked-prefill", "--prefill-chunk", "2048"]
    if kv_policy_file:
        argv += ["--kv-policy", str(kv_policy_file)]
    args = serve.build_parser().parse_args(argv)
    policy = serve.make_policy(cfg, model, args, max_len)
    engine = serve.make_engine(model, params, policy, args)
    kv = policy.kv_bits is not None
    label = (f"tiny[{cfg.name} page={page} "
             f"{'chunked' if chunked else 'whole'} "
             f"kv={policy.kv_bits or 'bf16'}]")
    dec = "paged_attention_quant_fwd" if kv else "paged_attention_fwd"
    pre = ("paged_prefill_quant_fwd" if kv else "paged_prefill_fwd") \
        if chunked else "flash_attention_fwd"
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    # the oracle: generate over the same pool, prefilling as the run
    # does (32-token chunks through the paged walk, or the whole
    # prompt through the whole-sequence forward)
    want = {r.rid: serve.generate(
        model, params, torch.from_numpy(r.prompt[None]).cuda(),
        r.max_new, page_size=page, kernel="cuda", kv_bits=policy.kv_bits,
        prefill_chunk=policy.prefill_chunk if chunked else 0)[0]
        .cpu().numpy() for r in reqs}
    for name, n in launches.items():
        if name in (dec, pre) and n <= 0:
            fail(f"{label}: kernel {name} was never launched")
        if name not in (dec, pre) and n:
            fail(f"{label}: kernel {name} launched {n} times on a path "
                 f"that should not reach it")
    same = 0
    for r in reqs:
        got, ref_toks = outs[r.rid], want[r.rid]
        if got.shape != ref_toks.shape:
            fail(f"{label}: request {r.rid} returned {got.shape}, "
                 f"generate {ref_toks.shape}")
        diff = np.nonzero(got != ref_toks)[0]
        if diff.size:
            i = int(diff[0])
            fail(f"{label}: request {r.rid} (prompt {len(r.prompt)}) "
                 f"differs from generate at token {i}: "
                 f"{got[i:i + 4].tolist()} vs "
                 f"{ref_toks[i:i + 4].tolist()}")
        same += 1
    ran = {k: v for k, v in launches.items() if v}
    print(f"{label}: {same}/{len(reqs)} requests token-identical to "
          f"generate, {engine.stats['decode_ticks']} decode ticks in "
          f"{dt:.3f} s; launches {json.dumps(ran)}", flush=True)


# ------------------------------------------- granite-moe and AMC (G = 3) --
# AMC (core/amc.py) on each full-width model: a FLOPs target of 0.5 over
# AMC_EPISODES exploring episodes and the greedy rollout, every policy
# scored by Model.loss on one held-out (1, AMC_S) batch of seeded tokens
# (flash attention in every layer: AMC_S >= FLASH_MIN), then the uniform
# baseline at keep 0.5
AMC_TARGET, AMC_EPISODES, AMC_S = 0.5, 8, 4096


def phase_moe_kernels(prefill_chunk: int, n_blocks_main: int):
    """Phase 2b: the three kernels granite-moe's paths run, at its
    geometry (MOE_GEO: hd 64, G = 3, decode GC = 1; page 16, no cap,
    global): paged_attention_fwd on a decode tick of 8 ragged sequences,
    paged_prefill_fwd on a ``prefill_chunk``-row chunk, flash_attention_fwd
    causal at S = 4096 (an AMC episode's loss). Each is held against its
    plain version at the phase 2 tolerance, then timed on the same inputs
    beside the plain version, SDPA and its bound, and printed. Returns
    name -> record."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    nq, nkv, hd = MOE_GEO
    if pa.head_group(nq // nkv) != 1:
        fail(f"granite-moe's G = {nq // nkv} should give decode GC = 1")
    specs = kernel_specs()
    rng = np.random.default_rng(0)
    dec_pos = sorted([0, 17, 4095, 4097, 4999]
                     + rng.integers(1, 5000, 3).tolist())
    dec_blocks = max(n_blocks_main, -(-5000 // PAGE) + 1)
    records = {}
    for name, positions, Sq, n_blocks in (
            ("paged_attention_fwd", dec_pos, 1, dec_blocks),
            ("paged_prefill_fwd", [0], prefill_chunk, n_blocks_main)):
        fwd, plain, _, is_dec = specs[name]
        qs, pools, pt, pos = paged_case(500 + Sq, positions, Sq, n_blocks,
                                        heads=(nq, nkv), hd=hd)
        err = check_kernel(f"{name}[G=3 hd=64]", fwd, plain, qs, pools, pt,
                           pos, window=0, cap=0.0)
        q = qs[0.0]
        ms = device_ms(lambda: fwd(q, *pools, pt, pos, window=0, cap=0.0))
        plain_ms = time_ms(lambda: plain(q, *pools, pt, pos, window=0,
                                         cap=0.0), reps=2, warmup=1)
        lib_ms = device_ms(sdpa_yardstick(q, *pools, pt, pos, 0), reps=10)
        b_ms, by = bound_ms(positions, Sq, n_blocks, 0, geo=MOE_GEO)
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": by}
        print(f"kernels[G=3]: {name} B={len(positions)} Sq={Sq} "
              f"n_blocks={n_blocks} H={nq} K={nkv} hd={hd}, "
              f"{paged_plan(is_dec, len(positions), Sq, n_blocks, MOE_GEO)}"
              f": {ms:.4f} ms (plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms by {by}, {100 * b_ms / ms:.1f}% of "
              f"it)", flush=True)
        del qs, q, pools, pt, pos
        torch.cuda.empty_cache()
    S = 4096
    qs, k, v = flash_case(60, S, geo=MOE_GEO)
    q = qs[0.0]

    def ffwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def fplain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    err = check_kernel("flash_attention_fwd[G=3 hd=64]", ffwd, fplain, qs,
                       (k, v), None, None, window=0, cap=0.0)
    ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                   reps=10)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       reps=2, warmup=1)
    torch.cuda.empty_cache()
    lib_ms = device_ms(flash_sdpa(q, k, v, 0), reps=10)
    b_ms, by = flash_bound_ms(S, 0, geo=MOE_GEO)
    records["flash_attention_fwd"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by}
    print(f"kernels[G=3]: flash_attention_fwd B=1 S={S} H={nq} K={nkv} "
          f"hd={hd} causal: {ms:.4f} ms (plain {plain_ms:.3f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {by}, "
          f"{100 * b_ms / ms:.1f}% of it)", flush=True)
    del qs, q, k, v
    torch.cuda.empty_cache()
    return records


def phase_amc(model, params):
    """Phase 9: AMC on the full-width model: ``amc.search`` (AMC_TARGET,
    AMC_EPISODES) and ``amc.uniform_baseline`` at keep 0.5, every policy
    scored by ``Model.loss`` on one (1, AMC_S) batch of seeded tokens.
    Each scored policy is recorded where the env masks it
    (``amc.apply_ratios``, wrapped for the phase): its ratios, its FLOPs
    fraction, its loss, the seconds from masking to loss, and the flash
    launches of its loss (one per layer). Fails unless every FLOPs
    fraction is within the target, every loss is finite, flash attention
    ran in every layer of every loss, and (moe layers) the experts each
    mask prunes have every router logit at -1e8 or below and the kept
    ones none. Returns the phase's summary."""
    import math
    import torch
    from repro_torch.core import amc, pruning
    from repro_torch.kernels import flash_attention as fa

    cfg = model.cfg
    label = f"amc[{cfg.name}]"
    g = torch.Generator().manual_seed(9)
    toks = torch.randint(2, cfg.vocab_size, (1, AMC_S), generator=g,
                         dtype=torch.int32).cuda()
    batch = {"tokens": toks, "labels": toks}
    layers = amc.enumerate_layers(model, 4096)
    total = sum(l.flops for l in layers)
    rows = []
    apply_ratios = amc.apply_ratios

    def node(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    def recording_apply(p, lays, ratios):
        t0 = time.perf_counter()
        masked = apply_ratios(p, lays, ratios)
        used = 0.0
        for l, r in zip(lays, ratios):
            used += l.flops * r
        for l, r in zip(lays, ratios):
            if l.kind != "moe":
                continue
            keep = pruning.keep_mask(
                pruning.expert_importance(node(p, l.path)), r) > 0
            router = node(masked, l.path)["router"]
            low = (router <= -1e8).flatten(0, -2).all(0)
            if not torch.equal(low, ~keep):
                fail(f"{label}: {l.name} at keep {r:.4f}: router columns "
                     f"at <= -1e8 {low.nonzero().flatten().tolist()}, "
                     f"pruned experts {(~keep).nonzero().flatten().tolist()}")
        rows.append({"ratios": list(ratios), "flops_frac": used / total,
                     "t0": t0})
        return masked

    def eval_loss(p):
        t0 = time.perf_counter()
        before = fa.LAUNCHES["flash_attention_fwd"]
        loss = float(model.loss(p, batch))
        n = fa.LAUNCHES["flash_attention_fwd"] - before
        if n != cfg.num_layers or not math.isfinite(loss):
            fail(f"{label}: Model.loss {loss} with {n} flash launches over "
                 f"{cfg.num_layers} layers")
        if rows and "loss" not in rows[-1]:
            rows[-1].update(loss=loss, flash=n,
                            s=time.perf_counter() - rows[-1]["t0"])
        else:
            base.update(loss=loss, s=time.perf_counter() - t0)
        return loss

    base = {}
    acfg = amc.AMCConfig(target=AMC_TARGET, episodes=AMC_EPISODES)
    amc.apply_ratios = recording_apply
    try:
        t0 = time.perf_counter()
        res = amc.search(model, params, eval_loss, acfg)
        search_s = time.perf_counter() - t0
        uni = amc.uniform_baseline(model, params, eval_loss, 0.5)
    finally:
        amc.apply_ratios = apply_ratios
    torch.cuda.empty_cache()
    if len(rows) != AMC_EPISODES + 2:
        fail(f"{label}: {len(rows)} policies scored, want "
             f"{AMC_EPISODES + 2}")
    names = [f"episode {i}" for i in range(AMC_EPISODES)] + \
        ["greedy", "uniform"]
    for name, row in zip(names, rows):
        if row["flops_frac"] > AMC_TARGET + 1e-6:
            fail(f"{label}: {name} FLOPs fraction {row['flops_frac']:.6f} "
                 f"over the target {AMC_TARGET}")
        print(f"{label}: {name}: ratios "
              f"{[round(r, 4) for r in row['ratios']]} flops_frac "
              f"{row['flops_frac']:.6f} loss {row['loss']:.6f} "
              f"({row['s']:.3f} s, {row['flash']} flash launches)",
              flush=True)
    per_ep = sum(r["s"] for r in rows[:-1]) / (AMC_EPISODES + 1)
    print(f"{label}: {len(layers)} prunable layers "
          f"{[l.name for l in layers]}; base loss {base['loss']:.6f} "
          f"({base['s']:.3f} s); best {res['best']['loss']:.6f} at "
          f"flops_frac {res['best']['flops_frac']:.6f}; uniform keep 0.5 "
          f"{uni['loss']:.6f}; search {search_s:.1f} s, {per_ep:.3f} s per "
          f"episode (masking and loss); "
          f"{sum(r['flash'] for r in rows)} flash launches", flush=True)
    return {"s_per_episode": per_ep, "search_s": search_s}


def phase_moe_serve(model, params, gemma_summary):
    """Phase 10: full-width granite-moe served. (a) one chunk and one
    decode step through the kernels against the plain walk (phase 3);
    (b) the main trace through the launcher's own construction
    (``--arch granite-moe-3b-a800m --max-batch 8``, chunked, bf16 pool):
    the bf16 paged pair launched and nothing else, tok/s and tick times
    against gemma2-2b's bf16 run; (c) its first 4 requests profiled
    (phase 5); (d)
    the share of routed (token, expert) pairs each chunk tick of (b)
    dropped past capacity (``moe.dispatch`` wrapped for the run), which
    must be 0 in every decode tick; (e) ``serve.main`` itself on its
    default trace, the paged pair launched."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import moe

    cfg = model.cfg
    tag = f"{cfg.name} "
    phase_model(model, params, tag=tag)
    # every dispatch of the timed run counts its dropped pairs on the
    # device (one reduction a layer, no host read until the run ends)
    calls = []
    dispatch = moe.dispatch

    def counting(idx, C, E, **kw):
        order, keep, dest = dispatch(idx, C, E, **kw)
        calls.append((idx.shape[0], keep.numel(), (~keep).sum()))
        return order, keep, dest

    moe.dispatch = counting
    try:
        launches, policy, args, summary = phase_engine(
            model, params, tag=tag, bf16_summary=gemma_summary)
    finally:
        moe.dispatch = dispatch
    # the first 4 requests: the profiler's post-processing grows with the
    # ~60 device activities a moe layer adds to every tick
    phase_profile(model, params, policy, args, tag=tag, n_top=14,
                  n_requests=4)
    L = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    ticks = [calls[i:i + L] for i in range(0, len(calls), L)]
    chunk, decode = [], [0, 0]
    for tick in ticks:
        pairs = sum(c[1] for c in tick)
        dropped = int(sum(c[2] for c in tick))
        if tick[0][0] <= policy.max_batch:        # one row a sequence
            decode[0] += pairs
            decode[1] += dropped
        else:
            chunk.append((tick[0][0], dropped / pairs))
    if decode[1]:
        fail(f"moe[{cfg.name}]: decode ticks dropped {decode[1]} of "
             f"{decode[0]} routed pairs; decode is drop-free by capacity")
    print(f"moe[{cfg.name}]: routed pairs dropped past capacity "
          f"(capacity_factor {cfg.moe.capacity_factor}, {L} moe layers): "
          f"decode ticks {decode[1]}/{decode[0]}; chunk ticks "
          + ", ".join(f"{100 * share:.3f}%" for _, share in chunk)
          + f" (rows {sorted({n for n, _ in chunk})}; capacity "
          f"{moe.capacity(policy.prefill_chunk, cfg.moe)} of "
          f"{policy.prefill_chunk} rows x {cfg.moe.experts_per_token} / "
          f"{cfg.moe.num_experts} experts)", flush=True)

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    serve.main(["--arch", MOE_ARCH, "--max-batch", "8"])
    torch.cuda.synchronize()
    cli = all_launches()
    for name in BF16_KERNELS:
        if cli[name] <= 0:
            fail(f"serve.main --arch {MOE_ARCH}: kernel {name} was never "
                 f"launched")
    print(f"moe[{cfg.name}]: serve.main --arch {MOE_ARCH} --max-batch 8 "
          f"in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps({k: v for k, v in cli.items() if v})}", flush=True)
    return launches, summary


# ------------------------------------------------------------- training ----
# phase 12's full-width run: `python -m repro_torch.launch.train` with
# these flags (remat on, the reference's default)
TRAIN_ARGS = ["--arch", "gemma2-2b", "--batch", "2", "--seq", "4096",
              "--steps", "8", "--ckpt-every", "0", "--log-every", "1"]
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 8
# the kernel's lse against the plain version's: its l sums the
# bf16-rounded weights (up to 2**-9 of each) and its scores carry the
# softcap2 and ex2.approx errors (within 5e-5 at a cap of 50)
LSE_ATOL = 2.0 ** -8
# dq, dk, dv from the kernel's out and lse through the backward, against
# autograd of the fp32 dense plain version, per element of each gradient's
# max |g|: P off by the lse's 2**-9, delta = dout . out read from the bf16
# out, each gradient rounded to bf16 (an emulation of those errors on the
# CPU reaches 4.2e-3)
BWD_TOL = 2.0 ** -6
# (H, K, hd, S, window, cap) of phase 12(a): gemma2-2b's heads, global and
# local (window 4096), cap 50 and 0; granite-moe's (G 3, no cap)
TRAIN_GEOS = ((8, 4, 256, 4096, 0, CAP), (8, 4, 256, 4096, 0, 0.0),
              (8, 4, 256, 4096, WINDOW, CAP), (24, 8, 64, 4096, 0, 0.0))


def flash_bwd_bound_ms(B, S, window, geo):
    """The backward's least time: 2.5x the forward's operations (the
    forward's two products and the backward's five, at twice the flops of
    the forward's two) over the bf16 peak; its bytes (q, k, v, out, dout
    and lse read once, dq, dk, dv written once) over the memory rate are
    far below."""
    H, K, hd = geo
    ops = 2.5 * 4.0 * hd * H * B * flash_valid_pairs(S, window)
    byts = 2 * B * S * hd * (4 * H + 4 * K) + 4 * B * H * S
    return max(ops / BF16_FLOPS, byts / HBM_BYTES_PER_S) * 1e3


def sdpa_train_ms(q, k, v, dout, reps=5):
    """SDPA's forward and backward on the same bf16 q, k, v (no softcap:
    SDPA has none; causal): the yardstick beside the backward, never
    called by the port."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def step():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qt, kt, vt), dt)
    return time_ms(step, reps=reps)


def phase_train_flash():
    """Phase 12(a): the flash kernel's lse and the backward at the
    training path's shapes (B = 2, S = 4096). The kernel's lse within
    LSE_ATOL of the plain version's, ``out`` with the lse asked for equal
    bit for bit to ``out`` without it; dq, dk, dv through the kernel's
    forward and models/flash.py's backward against autograd of the fp32
    dense plain version (BWD_TOL); the backward's time (plain PyTorch,
    CUDA events around host calls) beside SDPA's forward and backward and
    its bound. Returns the backward's row at gemma2-2b's global layer."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import flash as mflash

    rows = {}
    lse_err = bwd_err = 0.0
    for H, K, hd, S, window, cap in TRAIN_GEOS:
        g = torch.Generator(device="cuda").manual_seed(hd + window)
        B = TRAIN_B
        q = torch.randn((B, S, H, hd), generator=g, device="cuda")
        q = (q * (CAP_Q_SCALE if cap else 1.0)).bfloat16()
        k, v, = (torch.randn((B, S, K, hd), generator=g,
                             device="cuda").bfloat16() for _ in range(2))
        dout = torch.randn((B, S, H, hd), generator=g,
                           device="cuda").bfloat16()
        kw = dict(causal=True, window=window, cap=cap)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        if not torch.equal(out, fa.flash_attention_fwd(q, k, v, **kw)):
            fail(f"train[flash H={H} hd={hd}]: out with the lse asked for "
                 f"differs from out without it")
        _, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        e = float((lse - want_lse).abs().max())
        if not e <= LSE_ATOL:
            fail(f"train[flash H={H} hd={hd} window={window} cap={cap}]: "
                 f"lse off the plain version's by {e:.4g} > {LSE_ATOL:.4g}")
        lse_err = max(lse_err, e)
        del want_lse
        # the backward through models/flash.py, the kernel in its forward
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kind = "local" if window else "global"
        fa.reset_launches()
        o = mflash.flash_attention(*ins, kind, window, cap, kernel="cuda")
        got = torch.autograd.grad(o, ins, dout)
        if fa.LAUNCHES["flash_attention_fwd"] != 1:
            fail("train[flash]: models/flash.py did not launch the kernel "
                 "once")
        del o, ins
        torch.cuda.empty_cache()
        ref_ins = [t.float().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(
            *ref_ins, **kw), ref_ins, dout.float())
        del ref_ins
        errs = [float((a - b.float()).abs().max() / a.abs().max())
                for a, b in zip(want, got)]
        del want, got
        torch.cuda.empty_cache()
        if not max(errs) <= BWD_TOL:
            fail(f"train[flash H={H} hd={hd} window={window} cap={cap}]: "
                 f"dq, dk, dv off autograd of the fp32 plain version by "
                 f"{errs} of max |g| > {BWD_TOL:.4g}")
        bwd_err = max(bwd_err, max(errs))
        ms = time_ms(lambda: mflash.flash_backward(
            q, k, v, out, lse, dout, causal=True, window=window, cap=cap),
            reps=3, warmup=1)
        lib = sdpa_train_ms(q, k, v, dout)
        fwd = device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, return_lse=True, **kw), reps=10)
        fwd_plain = device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                              reps=10)
        bound = flash_bwd_bound_ms(B, S, window, (H, K, hd))
        print(f"train[flash B={B} S={S} H={H} K={K} hd={hd} window={window}"
              f" cap={cap}]: lse max |err| {e:.4g}; dq/dk/dv max |err| "
              f"{', '.join(f'{x:.3g}' for x in errs)} of max |g|; backward "
              f"{ms:.3f} ms (plain PyTorch, fp32) against its bound "
              f"{bound:.4f} ms ({ms / bound:.1f}x); kernel forward with lse "
              f"{fwd:.4f} ms, without {fwd_plain:.4f} ms; sdpa "
              f"forward+backward (no cap) {lib:.3f} ms",
              flush=True)
        rows[(H, window, cap)] = {"ms": ms, "bound_ms": bound,
                                  "library_ms": lib, "fwd_ms": fwd}
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    print(f"train[flash]: lse within {LSE_ATOL:.4g} (max {lse_err:.4g}); "
          f"backward within {BWD_TOL:.4g} of max |g| (max {bwd_err:.4g})",
          flush=True)
    return rows[TRAIN_GEOS[0][0], 0, CAP]


def train_busy_share(model, state, shape):
    """One more full-width train step on ``state`` under torch.profiler:
    (device busy ms, wall ms, the top device kernels as (name, ms))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import OptimConfig, TrainConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.training import steps

    tcfg = TrainConfig(optim=OptimConfig(total_steps=TRAIN_STEPS,
                                         warmup_steps=1))
    step = steps.make_train_step(model, tcfg)
    batch = dp.batch_for_model(model, shape, None, TRAIN_STEPS, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, _ = device_time_by_name(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return sum(by_name.values()), wall, top


def phase_train_full():
    """Phase 12(b): full-width gemma2-2b trained by ``launch.train`` (8
    steps, B = 2 x S = 4096, remat on, no checkpoint), every kernel count
    zeroed just before and read just after: flash_attention_fwd launched
    26 x 2 a step (the forward and the backward's recompute), no other
    kernel; every loss and grad norm finite, the last loss below the
    first. Prints step time, tokens/s, peak memory and the device busy
    share of one more step. Returns (the run's state, its launches, the
    median step time in seconds, the peak bytes allocated above what was
    allocated before)."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import build_model

    L = 26
    gc.collect()        # earlier phases' engines and pools, if in cycles
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        t0 = time.perf_counter()
        out = train_cli.main(TRAIN_ARGS + ["--ckpt-dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        if any(Path(tmp).iterdir()):
            fail("train: --ckpt-every 0 wrote a checkpoint")
    peak = torch.cuda.max_memory_allocated() - base
    hist = out["history"]
    if [r["step"] for r in hist] != list(range(TRAIN_STEPS)):
        fail(f"train: history steps {[r['step'] for r in hist]}")
    bad = [r for r in hist if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad:
        fail(f"train: non-finite loss or grad norm {bad}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        fail(f"train: loss did not fall ({hist[0]['loss']} -> "
             f"{hist[-1]['loss']})")
    want = {"flash_attention_fwd": L * 2 * TRAIN_STEPS}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"train: launches {got}, expected {want} (26 layers, the "
             f"forward and the remat recompute, {TRAIN_STEPS} steps)")
    dts = sorted(r["dt_s"] for r in hist[1:])
    step_s = dts[len(dts) // 2]
    model = build_model(get_config("gemma2-2b"))
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    busy, prof_wall, top = train_busy_share(model, out["state"], shape)
    losses = ", ".join(f"{r['loss']:.4f}" for r in hist)
    norms = ", ".join(f"{r['grad_norm']:.3f}" for r in hist)
    print(f"train[gemma2-2b B={TRAIN_B} S={TRAIN_S}]: {TRAIN_STEPS} steps in "
          f"{wall:.1f} s (first step {hist[0]['dt_s']:.3f} s, median of the "
          f"rest {step_s:.3f} s, {TRAIN_B * TRAIN_S / step_s:.0f} tokens/s); "
          f"losses {losses}; grad norms {norms}; peak memory "
          f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated above the "
          f"{base / 1e9:.2f} GB allocated before); "
          f"launches {json.dumps(got)}; one more step profiled: "
          f"{prof_wall:.1f} ms wall, device busy {busy:.1f} ms "
          f"({100 * busy / prof_wall:.1f}%); top device time: "
          + "; ".join(f"{k[:70]} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in top), flush=True)
    return out["state"], launches, step_s, peak


def _flash_perturbed(q, k, v, *, causal, window, cap, mode, return_lse=False):
    """The plain flash forward with the kernel's rounding as noise: the
    fp32 output moved by a random 2**-9 of itself before its bf16
    rounding, and the lse by a random 2**-9 (phase 12(c)'s control)."""
    import torch
    from repro_torch.kernels import ref
    out, lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window,
                                       cap=cap, return_lse=True)
    g = torch.Generator(device=q.device).manual_seed(int(q.shape[1]))
    noise = (torch.rand(out.shape, generator=g, device=q.device) * 2 - 1)
    out = (out * (1 + noise * 2.0 ** -9)).to(q.dtype)
    lse = lse + (torch.rand(lse.shape, generator=g, device=q.device)
                 * 2 - 1) * 2.0 ** -9
    return (out, lse) if return_lse else out


def phase_train_grads(params):
    """Phase 12(c): one full-width step's gradients (B = 2 x S = 4096, remat
    on) through the kernel (kernel "auto": 26 x 2 launches) and through the
    plain flash path (kernel "ref": none), on the same batch and trained
    params; per-leaf relative L2 distance. The bound comes from a control
    run in the same call: the plain path with its flash outputs moved by
    the kernel's own rounding (``_flash_perturbed``). Random-weight
    attention is saturated (scores far past the cap), so the attention
    projections' gradients are differences of nearly equal terms; each
    leaf is held to max(0.05, 4x the control's distance)."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models import flash as mflash
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves

    model = build_model(get_config("gemma2-2b"))
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    batch = dp.batch_for_model(model, shape, None, 0, "cuda")
    leaves = tree_leaves(params)
    names = []

    def walk(t, path):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], f"{path}/{key}" if path else key)
        else:
            names.append(path)
    walk(params, "")

    def grads(kernel):
        for p in leaves:
            p.requires_grad_(True)
        reset_all_launches()
        loss = model.loss(params, batch, remat=True, kernel=kernel)
        g = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        torch.cuda.synchronize()
        return float(loss.detach()), [x.float() for x in g], \
            all_launches()["flash_attention_fwd"]

    t0 = time.perf_counter()
    l_k, g_k, n_k = grads("auto")
    l_p, g_p, n_p = grads("ref")
    if (n_k, n_p) != (26 * 2, 0):
        fail(f"train[grads]: flash launches {n_k} (kernel) and {n_p} "
             f"(plain), expected 52 and 0")

    def dist(a, b):
        return [float(torch.linalg.norm(x - y) / torch.linalg.norm(x))
                for x, y in zip(a, b)]
    d_k = dist(g_p, g_k)
    g_p_norms = [torch.linalg.norm(x) for x in g_p]
    del g_k
    torch.cuda.empty_cache()
    real = mflash.kops.flash_attention
    mflash.kops.flash_attention = _flash_perturbed
    try:
        l_c, g_c, _ = grads("ref")
    finally:
        mflash.kops.flash_attention = real
    d_c = dist(g_p, g_c)
    del g_c, g_p
    torch.cuda.empty_cache()
    worst = sorted(zip(names, d_k, d_c), key=lambda r: -r[1])
    # the whole gradient as one vector, every leaf weighted by its size
    w = [float(x) ** 2 for x in g_p_norms]
    whole_k = math.sqrt(sum(d * d * n for d, n in zip(d_k, w)) / sum(w))
    whole_c = math.sqrt(sum(d * d * n for d, n in zip(d_c, w)) / sum(w))
    over = [(n, a, c) for n, a, c in worst if not a <= max(0.05, 4 * c)]
    print(f"train[grads]: loss kernel {l_k:.6f}, plain {l_p:.6f}, control "
          f"{l_c:.6f}; per-leaf relative L2 kernel vs plain (control): "
          + "; ".join(f"{n} {a:.3g} ({c:.3g})" for n, a, c in worst[:8])
          + f"; median {sorted(d_k)[len(d_k) // 2]:.3g}; the whole "
          f"gradient {whole_k:.3g} (control {whole_c:.3g}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if over:
        fail(f"train[grads]: leaves past max(0.05, 4x the control): {over}")


def phase_train_resume():
    """Phase 12(d): tiny gemma2-2b on the card (S = 2048: flash's kernel at
    hd 32) trained 6 steps in one run, and 3 steps, a checkpoint in a
    temporary directory, a restore and 3 more: losses and final state
    equal bit for bit."""
    import torch
    from repro_torch.configs import (OptimConfig, ShapeConfig, TrainConfig,
                                     tiny_config)
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train

    model = build_model(tiny_config("gemma2-2b"))
    shape = ShapeConfig("t", 2048, 2, "train")
    quiet = dict(device="cuda", log=lambda r: None)

    def tcfg(d, every):
        return TrainConfig(optim=OptimConfig(lr=1e-3, total_steps=6,
                                             warmup_steps=1),
                           checkpoint_dir=d, checkpoint_every=every,
                           log_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        whole = train(model, shape, tcfg(f"{tmp}/a", 0), num_steps=6,
                      **quiet)
        n = all_launches()["flash_attention_fwd"]
        train(model, shape, tcfg(f"{tmp}/b", 3), num_steps=3, **quiet)
        rest = train(model, shape, tcfg(f"{tmp}/b", 3), num_steps=6,
                     **quiet)
    if Path(tmp).exists():
        fail("train[resume]: the temporary directory was not removed")
    la = [r["loss"] for r in whole["history"]][3:]
    lb = [r["loss"] for r in rest["history"]]
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(tree_leaves(whole["state"]), tree_leaves(rest["state"]))]
    exact = la == lb and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(whole["state"]),
                                          tree_leaves(rest["state"])))
    print(f"train[resume tiny gemma2-2b S=2048]: losses 3-5 {la} in one "
          f"run, {lb} resumed; state max |diff| {max(diffs):.3g}; "
          f"{n} flash launches in the 6-step run", flush=True)
    if not exact:
        fail("train[resume]: the resumed run differs from the whole run")
    if n != model.cfg.num_layers * 2 * 6:
        fail(f"train[resume]: {n} flash launches, expected "
             f"{model.cfg.num_layers * 2 * 6}")


# ------------------------------------------------- the SSM family and NAS --
# phase 13: full-width mamba2-370m (48 layers, d 1024) and zamba2-1.2b (38
# layers, d 2048, its one shared attention block applied before each of 7
# groups of mamba layers) served by generate's dense-cache branch
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
SSM_B, SSM_S, SSM_GEN = 2, 4096, 32
# zamba2's shared attention (32 query heads over 32 kv heads of 64: G = 1)
# and the NAS supernet's (8 over 4 heads of 64) at its windows
ZAMBA_GEO = (32, 32, 64)
NAS_GEO = (8, 4, 64)
NAS_WINDOWS = (0, 1024, 4096)
# the reference's own bounds on prefill(S) + decode_step against
# forward(S+1) for the ssm and hybrid families
# (tests/test_decode_equivalence.py): chunked SSD vs the recurrence in
# bf16, and its fp32-exactness case
CONTRACT_TOL = {"bf16": 5e-2, "fp32": 2e-3}
# gemma2-2b's ring decode: a prompt past the 4096 window (a multiple of
# flash's 512-row blocks), then decode steps
RING_S, RING_STEPS = 4608, 16
# phase 14: the NAS search on the full backbone (21 blocks, d 512): the
# latency table at (8, 2048) on h100-sxm, data at (2, 2048)
NAS_LUT_SHAPE = (8, 2048)
NAS_DATA_SHAPE = (2, 2048)
NAS_WARMUP, NAS_STEPS = 8, 16


def flash_case_b(seed, B, S, geo):
    """bf16 q (B, S, H, hd), k and v (B, S, K, hd) on the card."""
    import torch
    H_, K_, HD_ = geo
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H_, HD_), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, K_, HD_), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, K_, HD_), generator=g, device="cuda").bfloat16()
    return q, k, v


def phase_ssm_flash():
    """Phase 13(a): flash against its plain version at zamba2's shared
    attention (B 2, S 4096, 32/32 heads of 64, causal, no cap) and at the
    NAS supernet's (B 2, S 2048, 8/4 heads of 64, windows 0, 1024 and
    4096), each timed beside its plain version, SDPA and its bound.
    Returns {label: row}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def fwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def plain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    rows = {}
    cases = [("zamba2", ZAMBA_GEO, 4096, 0)] + [
        (f"nas w{w}", NAS_GEO, 2048, w) for w in NAS_WINDOWS]
    for i, (label, geo, S, window) in enumerate(cases):
        q, k, v = flash_case_b(60 + i, SSM_B, S, geo)
        err = check_kernel("flash_attention_fwd", fwd, plain, {0.0: q},
                           (k, v), None, None, window=window, cap=0.0)
        torch.cuda.empty_cache()
        t = device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=True, window=window), reps=10)
        p = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window), reps=2, warmup=1)
        torch.cuda.empty_cache()
        lib = device_ms(flash_sdpa(q, k, v, window), reps=10)
        bnd, by = flash_bound_ms(S, window, geo)
        bnd *= SSM_B
        tflops = 4e-9 * geo[2] * geo[0] * SSM_B * \
            flash_valid_pairs(S, window) / t
        rows[label] = {"ms": t, "plain_ms": p, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        print(f"ssm[flash {label}]: B={SSM_B} S={S} H={geo[0]} K={geo[1]} "
              f"hd={geo[2]} window={window}: {t:.4f} ms ({tflops:.1f} "
              f"TFLOP/s, {100 * bnd / t:.1f}% of its bound {bnd:.4f} ms by "
              f"{by}); plain {p:.3f} ms; sdpa {lib:.4f} ms", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _ssm_prompt(cfg, seed, S=SSM_S):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(2, cfg.vocab_size, (SSM_B, S), generator=g,
                         dtype=torch.int32).cuda()


def phase_ssm_serve(arch):
    """Phase 13(b, c) on one full-width family: (b) ``generate`` on 2
    prompts of 4096 tokens, 32 new tokens, launches zeroed before and read
    after (flash once per shared-block application, nothing else); the
    prefill's logits through the kernel against the plain flash path;
    tok/s, prefill ms and decode-step ms. (c) The reference's contract:
    prefill(S) + decode_step against forward(S+1) at the last position,
    within CONTRACT_TOL of the largest |logit|, in the bf16 parameters and
    in fp32 copies (S = 4096 for mamba2; 2046 for zamba2, so both sides
    attend densely and the fp32 run needs no bf16 kernel: flash takes
    multiples of 512 from 2048 on). A bf16 result past its bound passes
    only where (b)'s control shows the model amplifying a rounding past
    it; the fp32 bound holds always. Returns the generate run's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import hybrid_groups
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    print(f"ssm[{arch}]: {model.param_count()} params "
          f"({model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    apps = len(hybrid_groups(cfg)) if cfg.family == "hybrid" else 0
    prompt = _ssm_prompt(cfg, 13)

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = serve.generate(model, params, prompt, SSM_GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    if out.shape != (SSM_B, SSM_S + SSM_GEN) or \
            not torch.equal(out[:, :SSM_S], prompt) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail(f"ssm[{arch}]: malformed output {tuple(out.shape)}")
    for name, n in launches.items():
        if n != (apps if name == "flash_attention_fwd" else 0):
            fail(f"ssm[{arch}]: {name} launched {n} times in generate, "
                 f"want {apps if name == 'flash_attention_fwd' else 0}")

    # the prefill timed alone, and through the kernel against the plain
    # flash path: every flash call of the kernel run also held against the
    # plain version on its own inputs, and a control run (the plain path
    # with a bf16 ulp on a tenth of each flash output) for the model's
    # own sensitivity to rounding
    V = cfg.vocab_size          # the vocab-padding columns sit at -1e9
    logits, calls = {}, {}
    for run, mode, probe in (("cuda", "cuda", {}), ("checked", "cuda",
                                                    {"check": True}),
                             ("ref", "ref", {}), ("ulp", "ref",
                                                  {"perturb": True})):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with attention_calls(names=("flash_attention",), **probe) \
                as calls[run]:
            lg, cache = model.prefill(params, {"tokens": prompt},
                                      cache_layout="full", kernel=mode)
        torch.cuda.synchronize()
        if run == "cuda":
            prefill_ms = (time.perf_counter() - t1) * 1e3
            keep = cache
        logits[run] = lg[:, 0, :V]
        del cache
    if calls["checked"]["n"] != apps:
        fail(f"ssm[{arch}]: {calls['checked']['n']} flash calls checked, "
             f"want {apps}")
    hold_logits(f"ssm[{arch}]", f"prefill S={SSM_S} (flash kernel vs plain;"
                f" {apps} calls each within tolerance of the plain version, "
                f"max |err| {calls['checked']['err']:.4g})",
                logits["cuda"], logits["ref"], logits["ulp"])
    cache = serve._grow_cache(keep, SSM_S, SSM_S + SSM_GEN)
    del keep
    tok = logits["cuda"].argmax(-1)[:, None].to(torch.int32)
    steps = []
    for i in range(SSM_GEN - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, tok,
                                      torch.tensor(SSM_S + i, device="cuda"))
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t1) * 1e3)
    del cache
    torch.cuda.empty_cache()
    step_ms = sorted(steps)[len(steps) // 2]
    print(f"ssm[{arch}]: generate {SSM_B} x {SSM_S}-token prompts + "
          f"{SSM_GEN} tokens in {dt:.3f} s ({SSM_B * SSM_GEN / dt:.1f} "
          f"tok/s); prefill {prefill_ms:.1f} ms, decode step "
          f"{step_ms:.2f} ms (median of {len(steps)}; min {min(steps):.2f},"
          f" max {max(steps):.2f}); launches {json.dumps(launches)}",
          flush=True)

    # (c) the decode contract, in the bf16 parameters and in fp32 copies
    amplifies = float((logits["ulp"] - logits["ref"]).abs().max()
                      / logits["ref"].abs().max())
    S = SSM_S if cfg.family == "ssm" else 2046
    toks = _ssm_prompt(cfg, 14, S + 1)
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.bfloat16 else a,
                   params)
    for label, p in (("bf16", params), ("fp32", p32)):
        full = model.forward(p, {"tokens": toks},
                             unembed_mode="last")[0][:, 0, :V]
        _, cache = model.prefill(p, {"tokens": toks[:, :S]})
        cache = serve._grow_cache(cache, S, S + 1)
        got = model.decode_step(p, cache, toks[:, S:],
                                torch.tensor(S, device="cuda"))[0][:, 0, :V]
        rel = float((got - full).abs().max() / full.abs().max())
        tol = CONTRACT_TOL[label]
        print(f"ssm[{arch}]: {label} prefill({S}) + decode_step vs "
              f"forward({S + 1}): max |diff| {rel:.4g} of the largest "
              f"|logit| ({float(full.abs().max()):.3g}; bound {tol})",
              flush=True)
        del cache
        if rel < tol:
            continue
        if label == "bf16" and amplifies > tol:
            print(f"ssm[{arch}]: bf16 contract past {tol}: the model moves "
                  f"its logits by {amplifies:.4g} of their max under a bf16 "
                  f"ulp on a tenth of its attention outputs (phase 13(b)'s "
                  f"control), so the fp32 contract holds the decode path",
                  flush=True)
            continue
        fail(f"ssm[{arch}]: {label} decode contract off by {rel:.4g}")
    del p32, params
    torch.cuda.empty_cache()
    return launches


def phase_ring_decode():
    """Phase 13(d): full-width gemma2-2b through the reference's serve
    step: ``make_prefill_step`` over 4608 tokens (ring caches: the local
    layers' last 4096 positions in ring slots) and RING_STEPS
    ``make_serve_step`` decodes, against ``decode_step_paged`` through the
    paged decode kernel over the same prompt's identity page pool,
    teacher-forced on the ring path's greedy tokens: every step's logits
    within LOGIT_RTOL, greedy tokens equal where the margin allows.
    Returns the flash launches of one prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.training import steps
    model = build_model(get_config("gemma2-2b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    cfg = model.cfg
    g = torch.Generator().manual_seed(15)
    prompt = torch.randint(2, cfg.vocab_size, (SSM_B, RING_S), generator=g,
                           dtype=torch.int32).cuda()
    torch.cuda.synchronize()
    reset_all_launches()
    logits, ring = steps.make_prefill_step(model)(params,
                                                  {"tokens": prompt})
    n_flash = all_launches()["flash_attention_fwd"]
    if n_flash != cfg.num_layers:
        fail(f"ring: prefill launched flash {n_flash} times, want "
             f"{cfg.num_layers}")
    if ring["sub0"]["k"].shape[2] != cfg.window_size:
        fail(f"ring: local caches hold {ring['sub0']['k'].shape[2]} slots")
    ring = {s: {kv: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, RING_STEPS)) if a.shape[2] == RING_S else a
        for kv, a in c.items()} for s, c in ring.items()}
    _, full = model.prefill(params, {"tokens": prompt},
                                  cache_layout="full")
    pool, pt = serve._identity_paged_pool(full, SSM_B, RING_S + RING_STEPS,
                                          PAGE)
    del full
    torch.cuda.empty_cache()
    serve_step = steps.make_serve_step(model)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    worst, ring_ms, paged_ms = 0.0, [], []
    reset_all_launches()
    for i in range(RING_STEPS):
        pos = RING_S + i
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a, ring = serve_step(params, ring, tok,
                             torch.tensor(pos, device="cuda"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        b, pool = model.decode_step_paged(
            params, pool, pt, tok,
            torch.full((SSM_B,), pos, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        ring_ms.append((t2 - t1) * 1e3)
        paged_ms.append((time.perf_counter() - t2) * 1e3)
        # the paged kernel's logits against the ring path's plain ones
        worst = max(worst, compare_logits(
            "ring", f"decode pos {pos} (paged kernel vs ring serve step)",
            b[:, 0], a[:, 0]))
        tok = a[:, -1].argmax(-1)[:, None].to(torch.int32)
    n = all_launches()
    if n["paged_attention_fwd"] != cfg.num_layers * RING_STEPS or \
            n["flash_attention_fwd"]:
        fail(f"ring: decode launches {json.dumps(n)}")
    print(f"ring[gemma2-2b]: {RING_S}-token prompt x {SSM_B}, "
          f"{RING_STEPS} steps: max logit diff {worst:.4g}; ring step "
          f"{sorted(ring_ms)[RING_STEPS // 2]:.2f} ms, paged step "
          f"{sorted(paged_ms)[RING_STEPS // 2]:.2f} ms (medians)",
          flush=True)
    del params, ring, pool
    torch.cuda.empty_cache()
    return n_flash


def phase_nas():
    """Phase 14: ``nas.search`` on the full backbone on the card, its LUT
    on h100-sxm at (8, 2048) and data at (2, 2048): every sampled path
    recorded, flash launched once for each attention op a forward ran
    (its backward is plain), losses and alpha finite, the derived arch
    with its expected and sampled latency; then each candidate op's
    forward timed at the LUT's shape beside the LUT's roofline value
    (printed, not gated). Returns the search's flash launches."""
    import torch
    from repro_torch.configs.supernet_lm import BACKBONE, CANDIDATE_OPS
    from repro_torch.core import latency_table as lt
    from repro_torch.core import nas
    from repro_torch.core import supernet as sn
    from repro_torch.core.hardware_model import H100_SXM
    lut = lt.build_lut(BACKBONE, *NAS_LUT_SHAPE, H100_SXM)
    data = nas.synthetic_lm_data(BACKBONE, *NAS_DATA_SHAPE, device="cuda")
    ncfg = nas.NASConfig(steps=NAS_STEPS, warmup_steps=NAS_WARMUP,
                         batch=NAS_DATA_SHAPE[0], seq=NAS_DATA_SHAPE[1],
                         log_every=4)
    sampled = []
    real = sn.sample_gates

    def recording(generator, alpha):
        g = real(generator, alpha)
        sampled.append(g.tolist())
        return g
    attn = {i for i, op in enumerate(CANDIDATE_OPS)
            if sn.OP_SPECS[op]["arm"] == "attn"}
    torch.cuda.synchronize()
    reset_all_launches()
    sn.sample_gates = recording
    t0 = time.perf_counter()
    try:
        res = nas.search(data, hw=H100_SXM, ncfg=ncfg, lut=lut,
                         device="cuda",
                         progress=lambda r: print(
                             f"nas: step {r['step']} weight loss "
                             f"{r['weight_loss']:.4f} arch loss "
                             f"{r['arch_loss']:.4f} val CE "
                             f"{r['val_ce']:.4f} E[lat] "
                             f"{r['e_lat_us']:.2f} us", flush=True))
    finally:
        sn.sample_gates = real
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = all_launches()
    want = sum(g in attn for gates in sampled for g in gates)
    if n["flash_attention_fwd"] != want or want == 0 or any(
            v for k, v in n.items() if k != "flash_attention_fwd"):
        fail(f"nas: launches {json.dumps(n)}, want {want} flash launches "
             f"(attention ops sampled over {len(sampled)} steps)")
    losses = [v for r in res["history"]
              for v in (r["weight_loss"], r["arch_loss"], r["val_ce"])]
    if not all(math.isfinite(v) for v in losses) or \
            not bool(torch.isfinite(torch.from_numpy(res["alpha"])).all()):
        fail(f"nas: non-finite losses or alpha: {res['history']}")
    if len(res["arch"]) != BACKBONE.num_layers:
        fail(f"nas: arch of {len(res['arch'])} blocks")
    steps_n = NAS_WARMUP + 2 * NAS_STEPS
    print(f"nas: {NAS_WARMUP} warmup + {NAS_STEPS} search steps on the "
          f"{BACKBONE.num_layers}-block backbone (d {BACKBONE.d_model}) at "
          f"B {NAS_DATA_SHAPE[0]} x S {NAS_DATA_SHAPE[1]} in {dt:.1f} s "
          f"({1e3 * dt / steps_n:.1f} ms a weight or alpha step); "
          f"{n['flash_attention_fwd']} flash launches; derived arch "
          f"{res['arch']}; E[lat] {res['e_lat_us']:.2f} us, sampled "
          f"{res['sampled_lat_us']:.2f} us, target {res['lat_ref_us']:.2f} "
          f"us (h100-sxm roofline at B {NAS_LUT_SHAPE[0]} x S "
          f"{NAS_LUT_SHAPE[1]})", flush=True)

    # each op's forward alone at the LUT's shape beside its roofline value
    params = res["params"]
    B, S = NAS_LUT_SHAPE
    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((B, S, BACKBONE.d_model), generator=g,
                    device="cuda").bfloat16()
    positions = torch.arange(S, device="cuda").expand(B, S)
    parts = []
    with torch.no_grad():
        for j, op in enumerate(CANDIDATE_OPS):
            block = params["blocks"][0][op]
            ms = time_ms(lambda: sn._apply_op(op, block, x, BACKBONE,
                                              positions), reps=5)
            parts.append(f"{op} {ms:.3f} ms (LUT {1e3 * float(lut[0, j]):.4f}"
                         f" ms)")
    print(f"nas[roofline fidelity, B {B} x S {S}, h100-sxm]: "
          + "; ".join(parts), flush=True)
    del params, res, x
    torch.cuda.empty_cache()
    return n["flash_attention_fwd"]


# ------------------------------------ the encoder-decoder and vision stub --
# phase 15: whisper-large-v3 at full width (32 encoder and 32 decoder
# layers, d 1280, 20/20 heads of 64: G = 1, no softcap, no RoPE) served
# through make_prefill_step on 16384 frames and a 2048-token decoder
# prompt, then W_STEPS greedy make_serve_step decodes: the encoder's flash
# is bidirectional at 16384, the decoder's causal at 2048, its cross
# attention 2048 x 16384 and each decode step's 1 x 16384 (T >= 8192);
# then trained at the reference's train_4k (4096 frames, 512 decoder
# tokens) with B 2
WHISPER = "whisper-large-v3"
WHISPER_GEO = (20, 20, 64)
W_FRAMES, W_PROMPT, W_STEPS = 16384, 2048, 16
W_TRAIN_ARGS = ["--arch", WHISPER, "--batch", "2", "--seq", "4096",
                "--steps", "4", "--ckpt-every", "0", "--log-every", "1"]
W_TRAIN_STEPS, W_TRAIN_B, W_TRAIN_S = 4, 2, 4096
# phase 16: llava-next-mistral-7b at full width (32 layers, d 4096, 32/8
# heads of 128: G = 4) prefilled through make_prefill_step on 2048 patch
# rows and 6144 tokens (causal flash over the 8192 rows), then L_STEPS
# greedy steps through the dense make_serve_step and through
# decode_step_paged over the identity page pool (the paged decode kernel)
LLAVA = "llava-next-mistral-7b"
LLAVA_GEO = (32, 8, 128)
L_PATCHES, L_TOKENS, L_STEPS = 2048, 6144, 16
# the reference's init draws wq and wk with fan-in H (their (d, H, hd)
# shape): at full width the scores reach a spread of ~256 and a bf16 ulp on
# a tenth of the attention outputs moves the logits by more than their size
# (phase 16's control at the init prints it). With wq and wk times 1/16
# that control stays inside the 3% bound, so logits and tokens can be held
# there (the CPU tests scale them by 1/8 at their widths for the same
# reason)
QK_SCALE = 1 / 16
# kv heads the plain flash version takes at a time at these lengths: its
# (B, H, S, T) fp32 scores for all 20 heads at 16384 x 16384 would be
# 21.5 GB a copy
PLAIN_KV_CHUNK = 4


def plain_by_heads(q, k, v, *, causal, window=0, cap=0.0):
    """The plain flash version (kernels/ref.py) over PLAIN_KV_CHUNK kv
    heads and their query heads at a time: per head the same
    arithmetic."""
    import torch
    from repro_torch.kernels import ref
    G = q.shape[2] // k.shape[2]
    c = PLAIN_KV_CHUNK
    return torch.cat([ref.flash_attention_ref(
        q[:, :, i * G:(i + c) * G], k[:, :, i:i + c], v[:, :, i:i + c],
        causal=causal, window=window, cap=cap)
        for i in range(0, k.shape[2], c)], dim=2)


def flash_bound_full(B, S, T, causal, geo):
    """Least time for one flash call of B sequences, S queries over T keys
    (bidirectional: S*T pairs; causal with S == T: S(S+1)/2): its bytes
    (q, k, v read and the output written once) over device memory or its
    4*hd flops per valid (query head, key) pair over the bf16 peak."""
    H, K, HD = geo
    pairs = S * (S + 1) // 2 if causal else S * T
    t_bytes = 2 * B * (2 * S * H * HD + 2 * T * K * HD) / HBM_BYTES_PER_S \
        * 1e3
    t_ops = 4.0 * HD * H * B * pairs / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_new_flash_geometries():
    """Phases 15(a) and 16(a): flash at the geometries phases 15-16 give
    it, each held against its plain version at the phase 2 tolerance on
    seeded inputs of the main path's shapes, then timed beside the plain
    version, SDPA and the bound: whisper's encoder (bidirectional, 16384
    frames), decoder (causal, 2048), cross attention (2048 x 16384) and
    decode step's cross attention (1 x 16384), at G 1, hd 64; llava's
    prefill (causal, 8192) at G 4, hd 128. Then the paged decode at
    llava's heads over one sequence at the first decode position (8192
    keys, page 16). Returns {label: row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rows = {}
    cases = [("whisper encoder", WHISPER_GEO, W_FRAMES, W_FRAMES, False),
             ("whisper decoder", WHISPER_GEO, W_PROMPT, W_PROMPT, True),
             ("whisper cross", WHISPER_GEO, W_PROMPT, W_FRAMES, False),
             ("whisper decode cross", WHISPER_GEO, 1, W_FRAMES, False),
             ("llava prefill", LLAVA_GEO, L_PATCHES + L_TOKENS,
              L_PATCHES + L_TOKENS, True)]
    for i, (label, geo, S, T, causal) in enumerate(cases):
        H_, K_, HD_ = geo
        g = torch.Generator(device="cuda").manual_seed(70 + i)
        q = torch.randn((1, S, H_, HD_), generator=g, device="cuda").bfloat16()
        k = torch.randn((1, T, K_, HD_), generator=g, device="cuda").bfloat16()
        v = torch.randn((1, T, K_, HD_), generator=g, device="cuda").bfloat16()

        def fwd(q, k, v, pt, pos, *, window, cap):
            return fa.flash_attention_fwd(q, k, v, causal=causal)

        def plain(q, k, v, pt, pos, *, window, cap):
            return plain_by_heads(q, k, v, causal=causal)

        err = check_kernel(f"flash_attention_fwd[{label}]", fwd, plain,
                           {0.0: q}, (k, v), None, None, window=0, cap=0.0)
        torch.cuda.empty_cache()
        t = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
                      reps=10)
        p = time_ms(lambda: plain_by_heads(q, k, v, causal=causal), reps=2,
                    warmup=1)
        torch.cuda.empty_cache()
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=10)
        bnd, by = flash_bound_full(1, S, T, causal, geo)
        plan = fa.flash_plan(S, T, H_ // K_, causal, 0, HD_)
        rows[label] = {"ms": t, "plain_ms": p, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        print(f"encdec+vlm[flash {label}]: S={S} T={T} H={H_} K={K_} "
              f"hd={HD_} {'causal' if causal else 'full'}, {plan.tiles} "
              f"row tiles of {plan.positions} positions: {t:.4f} ms "
              f"({100 * bnd / t:.1f}% of its bound {bnd:.4f} ms by {by}); "
              f"plain {p:.3f} ms; sdpa {lib:.4f} ms", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    positions = [L_PATCHES + L_TOKENS]
    n_blocks = -(-(L_PATCHES + L_TOKENS + L_STEPS) // PAGE)
    qs, pools, pt, pos = paged_case(80, positions, 1, n_blocks,
                                    heads=LLAVA_GEO[:2], hd=LLAVA_GEO[2])
    q = qs[0.0][:, 0].contiguous()

    def dec(q, *a, window, cap):
        return pa.paged_attention_fwd(q[:, 0], *a, window=window,
                                      cap=cap)[:, None]

    def dplain(q, *a, window, cap):
        return ref.paged_attention_ref(q[:, 0], *a, window=window,
                                       cap=cap)[:, None]
    err = check_kernel("paged_attention_fwd[llava decode]", dec, dplain,
                       {0.0: q[:, None]}, pools, pt, pos, window=0, cap=0.0)
    t = device_ms(lambda: pa.paged_attention_fwd(q, *pools, pt, pos))
    p = time_ms(lambda: ref.paged_attention_ref(q, *pools, pt, pos), reps=2,
                warmup=1)
    lib = device_ms(sdpa_yardstick(q[:, None], *pools, pt, pos, 0), reps=10)
    bnd, by = bound_ms(positions, 1, n_blocks, 0, geo=LLAVA_GEO)
    rows["llava paged decode"] = {"ms": t, "plain_ms": p, "library_ms": lib,
                                  "bound_ms": bnd, "bound_by": by,
                                  "max_abs_err": err}
    print(f"encdec+vlm[paged decode llava]: B=1 at position {positions[0]}, "
          f"n_blocks={n_blocks}, H={LLAVA_GEO[0]} K={LLAVA_GEO[1]} "
          f"hd={LLAVA_GEO[2]}, {paged_plan(True, 1, 1, n_blocks, LLAVA_GEO)}"
          f": {t:.4f} ms ({100 * bnd / t:.1f}% of its bound {bnd:.4f} ms by "
          f"{by}); plain {p:.3f} ms; sdpa {lib:.4f} ms", flush=True)
    del qs, q, pools, pt, pos
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def perturbed_attend():
    """The dense ``attention._attend`` (the dense-cache decode's
    attention) with a seeded tenth of each output moved by 2**-7 of its
    value, as ``attention_calls(perturb=True)`` moves the kernels' plain
    calls: the control of the model's own sensitivity to rounding."""
    import torch
    from repro_torch.models import attention as attn
    real = attn._attend
    n = [0]

    def moved(*args, **kw):
        out = real(*args, **kw)
        g = torch.Generator(device=out.device).manual_seed(n[0])
        n[0] += 1
        hit = torch.rand(out.shape, generator=g, device=out.device) < 0.1
        sign = torch.randint(0, 2, out.shape, generator=g,
                             device=out.device) * 2 - 1
        return (out.float() * (1 + hit * sign * 2.0 ** -7)).to(out.dtype)
    attn._attend = moved
    try:
        yield
    finally:
        attn._attend = real


def scale_qk(attn_trees, f):
    """wq and wk of every given attention subtree (stacked over layers)
    times ``f``, in place."""
    for t in attn_trees:
        for n in ("wq", "wk"):
            t[n].mul_(f)


def attention_trees(tree):
    """Every attention subtree of a parameter tree of any family (stacked
    over layers): the blocks', the hybrid's shared block's, the
    encoder's and the decoder's, its cross attention's included."""
    out = []
    for key in ("blocks", "shared", "enc", "dec"):
        sub = tree.get(key)
        for s in ((sub or {}).values() if key == "blocks"
                  else [sub] if sub else []):
            out += [s[n] for n in ("attn", "xattn") if n in s]
    return out


def whisper_decode(model, params, frames, prompt, label):
    """make_prefill_step on (frames, prompt), the self-attention caches
    grown (encdec.grow_cache: mk and mv stay), then W_STEPS greedy
    make_serve_step decodes, every count zeroed before and read after.
    Returns (launches, prefill ms, step ms, the tokens fed, the logits rows
    of the prefill and each step (W_STEPS + 1, V))."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.training import steps
    prefill, serve = steps.make_prefill_step(model), \
        steps.make_serve_step(model)
    V = model.cfg.vocab_size
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"frames": frames, "tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n_prefill = all_launches()["flash_attention_fwd"]
    cache = encdec.grow_cache(cache, W_PROMPT + W_STEPS)
    if cache["mk"].shape[2] != W_FRAMES or \
            cache["k"].shape[2] != W_PROMPT + W_STEPS:
        fail(f"whisper[{label}]: caches "
             f"{[(k, tuple(a.shape)) for k, a in cache.items()]}")
    rows, fed, steps_ms = [logits[:, 0, :V]], [], []
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    for i in range(W_STEPS):
        fed.append(tok)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = serve(params, cache, tok,
                          torch.tensor(W_PROMPT + i, device="cuda"))
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        rows.append(lg[:, 0, :V])
    launches = all_launches()
    L = model.cfg.num_layers
    want = {"flash_attention_fwd": 3 * L + L * W_STEPS}
    got = {k: v for k, v in launches.items() if v}
    if got != want or n_prefill != 3 * L:
        fail(f"whisper[{label}]: launches {got} ({n_prefill} in the "
             f"prefill), want {want} (3 x {L} in the prefill, {L} a step)")
    del cache
    torch.cuda.empty_cache()
    return (launches, prefill_ms, sorted(steps_ms)[W_STEPS // 2], fed,
            torch.cat(rows))


def phase_whisper_serve():
    """Phase 15(b): full-width whisper-large-v3 (random weights, seed 0)
    served by ``whisper_decode``: flash 32 x 3 in the prefill (encoder,
    decoder, cross) and 32 a step (cross attention at S = 1), no other
    kernel; prefill ms, decode-step ms and tok/s printed. At the
    reference's init a bf16 ulp anywhere moves the logits by more than
    their size, so the logits are held with wq and wk (encoder, decoder
    and cross attention) times QK_SCALE: the same path again, its prefill's
    and each step's logits against decode_fwd teacher-forced on the same
    tokens through the plain flash version (on the kernel's encoder
    memory), under phase 3's rule (hold_logits, its control the plain
    path with a bf16 ulp on a tenth of its flash outputs). Returns the
    launches of the run at the reference's init."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    print(f"whisper: {model.param_count()} params "
          f"({model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    frames = torch.randn((1, W_FRAMES, cfg.d_model), generator=g,
                         device="cuda").bfloat16()
    prompt = torch.randint(2, cfg.vocab_size, (1, W_PROMPT),
                           generator=torch.Generator().manual_seed(18),
                           dtype=torch.int32).cuda()
    launches, prefill_ms, step_ms, _, _ = whisper_decode(
        model, params, frames, prompt, "init")
    print(f"whisper[serve]: {W_FRAMES} frames + {W_PROMPT}-token prompt: "
          f"prefill {prefill_ms:.1f} ms; {W_STEPS} decode steps, median "
          f"{step_ms:.2f} ms ({1e3 / step_ms:.1f} tok/s); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)

    scale_qk([params["enc"]["attn"], params["dec"]["attn"],
              params["dec"]["xattn"]], QK_SCALE)
    _, _, _, fed, rows = whisper_decode(model, params, frames, prompt,
                                        f"wq, wk x {QK_SCALE}")
    # teacher-forced: prompt + the fed tokens, padded to flash's 512-row
    # blocks (causal: the padding rows come after every row compared)
    tf = torch.cat([prompt] + fed, dim=1)
    S_tf = -(-tf.shape[1] // 512) * 512
    tf = torch.nn.functional.pad(tf, (0, S_tf - tf.shape[1]))
    idx = torch.arange(W_PROMPT - 1, W_PROMPT + W_STEPS, device="cuda")
    V = cfg.vocab_size
    with torch.no_grad():
        mem = encdec.encode(params, frames, cfg)
        plain = {}
        for run, probe in (("ref", {}), ("ulp", {"perturb": True})):
            with attention_calls(names=("flash_attention",), **probe):
                lg, _ = encdec.decode_fwd(params, mem, tf, cfg,
                                          want_cache=False, kernel="ref")
            plain[run] = lg[0, idx, :V]
            del lg
            torch.cuda.empty_cache()
    hold_logits("whisper", f"wq, wk x {QK_SCALE}: prefill + {W_STEPS} serve "
                f"steps (flash kernel, S = 1 over {W_FRAMES} frames) vs "
                f"teacher-forced decode_fwd through the plain flash version",
                rows, plain["ref"], plain["ulp"])
    del params, mem, frames, plain, rows
    torch.cuda.empty_cache()
    return launches


def phase_whisper_train():
    """Phase 15(c): ``python -m repro_torch.launch.train --arch
    whisper-large-v3 --batch 2 --seq 4096 --steps 4`` (the reference's
    train_4k: 4096 frames, 512 decoder tokens; remat on), counts zeroed
    before and read after: flash 32 x 2 a step (the encoder's, forward
    and remat recompute; the decoder's 512 tokens and 512 x 4096 cross
    attention are dense), no other kernel; losses and parameters finite
    (the grad norm of the random-init model overflows to inf, see below).
    Prints losses, step time, peak memory and the device busy share of one
    more step. Returns the run's launches."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    L = get_config(WHISPER).num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        t0 = time.perf_counter()
        out = train_cli.main(W_TRAIN_ARGS + ["--ckpt-dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
    peak = torch.cuda.max_memory_allocated() - base
    hist = out["history"]
    if [r["step"] for r in hist] != list(range(W_TRAIN_STEPS)) or not all(
            math.isfinite(r["loss"]) and not math.isnan(r["grad_norm"])
            for r in hist):
        fail(f"whisper[train]: history {hist}")
    # random-init whisper's encoder gradient grows by orders of magnitude
    # every few layers in both packages (scripts/encdec_grad_norm.py), so
    # at 32 layers its square sum overflows fp32: the global norm is inf
    # and the clip zeroes the step, as in the reference; the parameters
    # must stay finite all the same
    bad = [i for i, a in enumerate(tree_leaves(out["state"]["params"]))
           if not bool(torch.isfinite(a).all())]
    if bad:
        fail(f"whisper[train]: non-finite parameters (leaves {bad})")
    want = {"flash_attention_fwd": L * 2 * W_TRAIN_STEPS}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"whisper[train]: launches {got}, want {want}")
    dts = sorted(r["dt_s"] for r in hist[1:])
    step_s = dts[len(dts) // 2]
    model = build_model(get_config(WHISPER))
    shape = ShapeConfig("train", W_TRAIN_S, W_TRAIN_B, "train")
    busy, prof_wall, top = train_busy_share(model, out["state"], shape)
    del out
    torch.cuda.empty_cache()
    tokens = W_TRAIN_B * (W_TRAIN_S + W_TRAIN_S // 8)
    print(f"whisper[train B={W_TRAIN_B} frames={W_TRAIN_S} decoder="
          f"{W_TRAIN_S // 8}]: {W_TRAIN_STEPS} steps in {wall:.1f} s (first "
          f"{hist[0]['dt_s']:.3f} s, median of the rest {step_s:.3f} s, "
          f"{tokens / step_s:.0f} frames+tokens/s); losses "
          + ", ".join(f"{r['loss']:.4f}" for r in hist)
          + f"; grad norms " + ", ".join(f"{r['grad_norm']:.3f}" for r in hist)
          + f"; peak memory {peak / 1e9:.2f} GB above the {base / 1e9:.2f} "
          f"GB allocated before; launches {json.dumps(got)}; one more step "
          f"profiled: {prof_wall:.1f} ms wall, device busy {busy:.1f} ms "
          f"({100 * busy / prof_wall:.1f}%); top device time: "
          + "; ".join(f"{k[:70]} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in top), flush=True)
    return launches


def llava_steps(model, params, step, state, first, label, feed=None,
                control=False, checked=0):
    """L_STEPS greedy steps of ``step(state, token, position)`` from token
    ``first`` at position L_PATCHES + L_TOKENS, counts zeroed before and
    read after; ``feed``: the tokens to feed instead of its own greedy
    ones (teacher forcing); ``control``: the dense attention perturbed
    (perturbed_attend); ``checked``: the first this many steps run every
    paged kernel call against its plain walk on its own inputs. Returns
    (tokens fed, logits rows (L_STEPS, V), median step ms, launches)."""
    import torch
    S = L_PATCHES + L_TOKENS
    V = model.cfg.vocab_size
    tok, toks, rows, ms = first, [], [], []
    reset_all_launches()
    for i in range(L_STEPS):
        if feed is not None:
            tok = torch.tensor([[feed[i]]], dtype=torch.int32,
                               device="cuda")
        toks.append(int(tok))
        probe = perturbed_attend() if control else \
            attention_calls(check=True) if i < checked else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with probe:
            lg, state = step(state, tok, S + i)
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        rows.append(lg[:, 0, :V])
    return toks, torch.cat(rows), sorted(ms)[L_STEPS // 2], all_launches()


def phase_llava():
    """Phase 16(b): full-width llava-next-mistral-7b (random weights, seed
    0): make_prefill_step on B 1, 2048 patch rows and 6144 tokens (32
    causal flash launches over 8192 rows), then L_STEPS greedy steps from
    it through the dense make_serve_step over the prefill's caches (grown)
    and through decode_step_paged over the identity page pool of a prefill
    in the full layout (the reference generate's pool; 32 paged decode
    launches a step), counts zeroed before each run and read after. At the
    reference's init a bf16 ulp on one attention output moves the logits
    by more than their size (the plain dense and the plain paged walks
    pick different tokens), so there the paged run is teacher-forced on
    the dense run's tokens, its first step's kernel calls each held
    against the plain walk on their own inputs and the logits under phase
    3's rule (hold_logits; its control the dense run with a bf16 ulp on a
    tenth of its attention outputs); then with wq, wk times QK_SCALE, both
    runs free: their tokens equal and their logits held under the same
    rule. Returns {run: launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.training import steps
    cfg = get_config(LLAVA)
    model = build_model(cfg)
    L = cfg.num_layers
    S = L_PATCHES + L_TOKENS
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    print(f"llava: {model.param_count()} params "
          f"({model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(19)
    batch = {"patches": torch.randn((1, L_PATCHES, cfg.d_model),
                                    generator=g, device="cuda").bfloat16(),
             "tokens": torch.randint(
                 2, cfg.vocab_size, (1, L_TOKENS),
                 generator=torch.Generator().manual_seed(20),
                 dtype=torch.int32).cuda()}
    serve_step = steps.make_serve_step(model)

    def dense(c, t, p):
        return serve_step(params, c, t, torch.tensor(p, device="cuda"))

    def paged(pt):
        return lambda pl, t, p: model.decode_step_paged(
            params, pl, pt, t, torch.full((1,), p, dtype=torch.int32,
                                          device="cuda"))

    out = {}
    for label in ("init", f"wq, wk x {QK_SCALE}"):
        if label != "init":
            scale_qk([params["blocks"]["sub0"]["attn"]], QK_SCALE)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        logits, cache = steps.make_prefill_step(model)(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        n = all_launches()
        got = {k: v for k, v in n.items() if v}
        if got != {"flash_attention_fwd": L}:
            fail(f"llava[{label}]: prefill launches {got}, want {L} flash")
        out.setdefault("prefill", n)
        _, full = model.prefill(params, batch, cache_layout="full")
        pool, pt = serve._identity_paged_pool(full, 1, S + L_STEPS, PAGE)
        del full
        cache = {s: {kv: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, L_STEPS)) for kv, a in c.items()}
            for s, c in cache.items()}
        ctrl = {s: {kv: a.clone() for kv, a in c.items()}
                for s, c in cache.items()}
        torch.cuda.empty_cache()
        first = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        d_toks, d_rows, d_ms, d_n = llava_steps(model, params, dense, cache,
                                                first, label)
        _, ulp, _, _ = llava_steps(model, params, dense, ctrl, first, label,
                                   feed=d_toks, control=True)
        init = label == "init"
        p_toks, p_rows, p_ms, p_n = llava_steps(
            model, params, paged(pt), pool, first, label,
            feed=d_toks if init else None, checked=1 if init else 0)
        if any(d_n.values()):
            fail(f"llava[{label}]: the dense serve step launched {d_n}")
        got = {k: v for k, v in p_n.items() if v}
        if got != {"paged_attention_fwd": L * L_STEPS}:
            fail(f"llava[{label}]: paged decode launches {got}, want "
                 f"{L * L_STEPS} paged_attention_fwd")
        greedy = [int(t) for t in p_rows.argmax(-1)]
        agree = sum(a == b for a, b in zip(greedy, d_toks[1:] + [int(
            d_rows[-1].argmax())]))
        if not init and p_toks != d_toks:
            fail(f"llava[{label}]: paged tokens {p_toks} != dense {d_toks}")
        hold_logits(f"llava[{label}]", f"{L_STEPS} decode steps (paged "
                    f"kernel{', teacher-forced' if init else ''} vs dense "
                    f"serve step)", p_rows, d_rows, ulp)
        print(f"llava[{label}]: {L_PATCHES} patches + {L_TOKENS} tokens: "
              f"prefill {prefill_ms:.1f} ms; {L_STEPS} greedy steps, dense "
              f"tokens {d_toks}, paged greedy equal at {agree} of "
              f"{L_STEPS}; dense serve step {d_ms:.2f} ms, paged step "
              f"{p_ms:.2f} ms (medians)", flush=True)
        out.setdefault("paged", p_n)
        del cache, ctrl, pool
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------- phase 17: the sharded engine --
# The gloo world's cut of the main trace: its first MESH_CUT requests (8
# until phase 18 came, 4 until phase 21 came, cut so the whole script stays
# inside 1200 s), MESH_GEN new tokens each (a chunk per prompt, then decode
# ticks). gloo moves a gather
# through the host at about 0.5 GB/s gathered (scripts/gloo_gather_rate.py),
# and a full-width call gathers the 1.18 GB embedding (lookup, unembed)
# and every layer's wo and w_out, so each takes seconds; the whole-prompt
# run: one prompt of MESH_WHOLE_S tokens (its bucket of 2048 rows: flash
# in every layer)
MESH_CUT, MESH_GEN, MESH_WHOLE_S = 2, 2, 2048
MESH_TP = 2                   # the gloo world's model axis
# the gloo world's full-width runs keep MESH_LAYERS of gemma2-2b's 26
# layers (their widths whole): a tick's gathers shrink with the depth, so
# that phases 17 and 18 stay well inside the script's 1200 s (6 until
# phase 21 came); the NCCL world of 1 runs all 26
MESH_LAYERS = 2
# a world's deadline: past it every rank is killed and the phase fails
MESH_WORLD_S = 600.0
MESH_SITES = ("attn_q", "attn_k", "attn_v", "ffn_in", "ffn_gate")


def mesh_runs(kv_policy_file):
    """Phase 17's runs, each {label, arch, tiny, argv, policy, reqs}: the
    policy is made here once (priced for the mesh) and given to the
    unsharded and the sharded engine alike. Returns (world-of-1 runs,
    gloo-world runs)."""
    import numpy as np
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Request

    def run(label, arch, tiny, argv, reqs, tp, layers=None):
        cfg = run_config({"arch": arch, "tiny": tiny, "layers": layers})
        model = build_model(cfg)
        argv = ["--arch", arch, "--max-batch", "8", "--page-size",
                str(PAGE), *(["--tiny"] if tiny else []), *argv,
                "--mesh", f"model={tp}"]
        args = serve.build_parser().parse_args(argv)
        max_len = max(len(r.prompt) + r.max_new for r in reqs)
        return {"label": label, "arch": arch, "tiny": tiny, "argv": argv,
                "reqs": reqs, "tp": tp, "layers": layers,
                "policy": serve.make_policy(cfg, model, args, max_len)}

    gemma = get_config("gemma2-2b")
    main = main_trace(gemma)
    cut = [Request(rid=r.rid, prompt=r.prompt, max_new=MESH_GEN)
           for r in main[:MESH_CUT]]
    rng = np.random.default_rng(7)
    whole = [Request(rid=0, prompt=rng.integers(
        2, gemma.vocab_size, MESH_WHOLE_S).astype(np.int32),
        max_new=MESH_GEN)]
    tiny = tiny_trace(tiny_config("gemma2-2b"), whole=False)
    one = [run("model=1 bf16", "gemma2-2b", False, [], main, 1)]
    two = [run("bf16", "gemma2-2b", False, [], cut, MESH_TP, MESH_LAYERS),
           run("int8", "gemma2-2b", False, ["--kv-bits", "8"], cut,
               MESH_TP, MESH_LAYERS),
           run("whole", "gemma2-2b", False, ["--no-chunked-prefill"],
               whole, MESH_TP, MESH_LAYERS),
           run("tiny bf16", "gemma2-2b", True,
               ["--paged-kernel", "cuda", "--prefill-chunk", "32"], tiny,
               MESH_TP),
           run("tiny mixed", "gemma2-2b", True,
               ["--paged-kernel", "cuda", "--prefill-chunk", "32",
                "--kv-policy", str(kv_policy_file)], tiny, MESH_TP)]
    return one, two


def run_config(run):
    """A phase 17 run's model config: tiny or full width, cut to the run's
    ``layers`` where it has them."""
    from repro_torch.configs import get_config, tiny_config
    cfg = tiny_config(run["arch"]) if run["tiny"] else get_config(run["arch"])
    return cfg.replace(num_layers=run["layers"]) if run["layers"] else cfg


def mesh_engine_run(run, mesh=None):
    """One run of phase 17 on this process's card: parameters from seed 0,
    the engine (sharded under ``mesh``) over ``run["reqs"]`` with the
    run's policy, the full-width runs' first 3 x L paged calls each held
    against the plain walk on their inputs; every logits row the engine
    samples from recorded (decode ticks, the prompts' last rows). Returns
    outputs, launches, logits, tick times and memory (allocated by this
    run: resident once the engine is built, peak over the run)."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves

    cfg = run_config(run)
    model = build_model(cfg)
    args = serve.build_parser().parse_args(run["argv"])
    # what this process held before the run (earlier phases' leftovers in
    # the parent; nothing in a rank) is not the run's
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    full_bytes = tensor_bytes(params)
    engine = serve.make_engine(model, params, run["policy"], args, mesh=mesh)
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() - held
    logits = []

    def record(fn, live=False):
        """Keep the logits rows the engine samples from: a decode tick's
        live slots (an idle slot's row reads the scratch page, which
        several idle slots write in an undefined order on the card)."""
        def call(*a):
            out = fn(*a)
            lg = out[0] if isinstance(out, tuple) else out
            rows = lg[:, 0, :cfg.vocab_size]
            if live:
                rows = rows[a[2][:, 0] != 0]
            logits.append(rows.float().cpu())
            return out
        return call

    engine._decode = record(engine._decode, live=True)
    engine._unembed_row = record(engine._unembed_row)
    make = engine._make_prefill
    engine._make_prefill = lambda: record(make())
    torch.cuda.synchronize()
    reset_all_launches()
    limit = None if run["tiny"] else 3 * cfg.num_layers
    t0 = time.perf_counter()
    with attention_calls(check=not run["tiny"], limit=limit) as checked:
        outs = engine.run(run["reqs"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    ticks = engine.telemetry.ticks
    ms = {k: [1e3 * t.measured_s for t in ticks if t.kind == k]
          for k in ("decode", "chunk", "prefill")}
    digest = hashlib.sha256(b"".join(
        x.numpy().tobytes() for x in logits)).hexdigest()
    return {"outs": outs, "launches": launches, "logits": logits,
            "digest": digest, "seconds": dt,
            "ms": {k: float(np.mean(v)) for k, v in ms.items() if v},
            "ticks": {k: len(v) for k, v in ms.items()},
            "resident_gb": resident / 1e9,
            "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
            "param_gb": tensor_bytes(engine.params) / 1e9,
            "full_param_gb": full_bytes / 1e9,
            "pool_gb": tensor_bytes(engine.kv.pool) / 1e9,
            "pool_heads": sorted({x.shape[3] for x in
                                  tree_leaves(engine.kv.pool)}),
            "checked": dict(checked)}


def mesh_rank(rank, world, device, runs):
    """A rank of phase 17's worlds: the serving mesh over the world
    (model = the runs' tp), then every run through the sharded engine."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = runs[0]["tp"]
    mesh = make_serving_mesh(model=tp, data=world // tp, device_type="cuda",
                             backend=torch.distributed.get_backend())
    torch.distributed.barrier()
    out = {}
    for run in runs:
        res = mesh_engine_run(run, mesh)
        if rank:
            res["logits"] = None         # rank 0's are compared; a digest
        out[run["label"]] = res          # holds every rank to them
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cublas_slices(cfg, runs):
    """Each local site's product over a rank's slice of the weight's
    columns against the same columns of the whole product, at the rows
    the runs give it (decode: max_batch; a chunk or a whole prompt: its
    padded rows), through the port's own functions (``_proj_in``,
    ``_matmul``). Returns {(site, rows): max |diff|}."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    g = torch.Generator(device="cuda").manual_seed(23)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"attn_q": (cfg.num_heads, hd), "attn_k": (cfg.num_kv_heads, hd),
              "attn_v": (cfg.num_kv_heads, hd), "ffn_in": (cfg.d_ff,),
              "ffn_gate": (cfg.d_ff,)}
    rows = sorted({(r["policy"].max_batch, 1) for r in runs}
                  | {(1, r["policy"].prefill_chunk) for r in runs})
    out = {}
    for site in MESH_SITES:
        w = (torch.randn((d,) + shapes[site], generator=g, device="cuda")
             * d ** -0.5).bfloat16()
        n = shapes[site][0]
        for B, S in rows:
            x = torch.randn((B, S, d), generator=g, device="cuda").bfloat16()
            worst = 0.0
            for r in range(MESH_TP):
                part = slice(r * n // MESH_TP, (r + 1) * n // MESH_TP)
                if site.startswith("attn"):
                    whole = attn._proj_in(x, w, site)[:, :, part]
                    local = attn._proj_in(x, w[:, part].contiguous(), site)
                else:
                    whole = layers._matmul(x, w, site)[..., part]
                    local = layers._matmul(x, w[:, part].contiguous(), site)
                worst = max(worst, float((local.float() - whole.float())
                                         .abs().max()))
            out[(site, B * S)] = worst
    return out


def phase_mesh(kv_policy_file):
    """Phase 17: the sharded engine (serving/engine/sharded.py) on the card.
    (a) an NCCL world of 1 rank: full-width gemma2-2b over the main trace
    through a model=1 mesh, tokens and every sampled logits row equal to
    the unsharded engine's bit for bit; (b) a gloo world of 2 ranks on this
    one card (NCCL refuses two ranks on one device; gloo's gathers go
    through host memory), model=2, 2 of the 4 kv heads per rank:
    full-width gemma2-2b cut to MESH_LAYERS layers on a cut of the main
    trace on the bf16 pool, on the int8 pool, and one whole prompt of 2048
    tokens through flash, each rank's pool holding K/2 heads, every rank's
    outputs and logits equal, the first 3 x MESH_LAYERS paged calls on a
    rank's slice held against the
    plain walk, tokens against the unsharded engine's (which runs here
    first): equal where every local product over a column slice equals
    the slice of the whole product on this card (``cublas_slices``), else
    the logits under LOGIT_RTOL; (c) tiny gemma2-2b at model=2 through the
    hd-32 kernels, bf16 and mixed pools, token-identical. Prints each
    world's backend, each rank's resident and peak memory against the
    unsharded engine's, and tick times (host-staged, not a speed).
    Returns the launches of the sharded runs, summed over ranks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import WorldFailed, spawn

    one, two = mesh_runs(kv_policy_file)
    card = card_line()
    cut = two[0]["reqs"]
    print(f"mesh: the gloo world serves a cut of the main trace: its first "
          f"{len(cut)} request(s) ({', '.join(str(len(r.prompt)) for r in cut)}"
          f" prompt tokens), {MESH_GEN} new tokens each, and one "
          f"{MESH_WHOLE_S}-token prompt whole; the NCCL world of 1 the whole "
          f"main trace", flush=True)
    slices = cublas_slices(get_config("gemma2-2b"), two[:3])
    exact = all(v == 0.0 for v in slices.values())
    print(f"mesh: cuBLAS, a rank's column slice vs the slice of the whole "
          f"product (max |diff|, {card}): "
          + ", ".join(f"{s}@{m} rows {v:.4g}" for (s, m), v in
                      slices.items()), flush=True)
    base = {}
    for run in one + two:
        base[run["label"]] = mesh_engine_run(run)
        gc.collect()
        torch.cuda.empty_cache()
    # the two worlds side by side: the gloo world's host-staged gathers
    # leave the card mostly idle
    def world(runs, n, backend):
        t0 = time.perf_counter()
        try:
            res = spawn(mesh_rank, n, backend=backend, device="cuda:0",
                        timeout_s=MESH_WORLD_S, args=(runs,))
        except WorldFailed as e:
            fail(f"mesh: the {backend} world of {n} failed:\n{e}")
        return res, time.perf_counter() - t0
    worlds = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [(backend, n, pool.submit(world, runs, n, backend))
                   for runs, n, backend in ((one, 1, "nccl"),
                                            (two, MESH_TP, "gloo"))]
        for backend, n, future in futures:
            worlds[backend], world_s = future.result()
            print(f"mesh[{backend}]: a world of {n} rank(s) on cuda:0, "
                  f"backend {backend}, {world_s:.1f} s (spawn, init and "
                  f"every run; the two worlds side by side)", flush=True)
            mark(f"phase 17's {backend} world")
    launches = {}
    for runs, backend in ((one, "nccl"), (two, "gloo")):
        ranks = worlds[backend]
        for run in runs:
            label = f"mesh[{backend} {run['label']}]"
            want = base[run["label"]]
            res = [r[run["label"]] for r in ranks]
            tp = run["tp"]
            kv = TINY_HEADS[1] if run["tiny"] else K
            for i, r in enumerate(res):
                if r["pool_heads"] != [kv // tp]:
                    fail(f"{label}: rank {i}'s pool leaves hold "
                         f"{r['pool_heads']} kv heads, want {kv // tp}")
                if r["digest"] != res[0]["digest"] or any(
                        not np.array_equal(r["outs"][k], res[0]["outs"][k])
                        for k in r["outs"]):
                    fail(f"{label}: rank {i}'s outputs or logits differ "
                         f"from rank 0's")
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            got = res[0]
            same = all(np.array_equal(got["outs"][r.rid], want["outs"][r.rid])
                       for r in run["reqs"])
            bitwise = got["digest"] == want["digest"]
            if (run["tiny"] or tp == 1 or exact) and not (same and bitwise):
                fail(f"{label}: sharded engine not bit-identical to the "
                     f"unsharded one (tokens equal: {same}, logits equal: "
                     f"{bitwise})")
            if not bitwise:
                # full width, a local product off its slice: the logits
                # of the ticks before the first token that differs
                for i, (a, b) in enumerate(zip(got["logits"],
                                               want["logits"])):
                    if not torch.equal(a.argmax(-1), b.argmax(-1)):
                        break
                    compare_logits(label, f"sampled rows {i}", a, b)
            c = got["checked"]
            print(f"{label}: {len(run['reqs'])} requests "
                  f"{'token-identical' if same else 'tokens differ'}"
                  f"{', logits bit-identical' if bitwise else ''} to the "
                  f"unsharded engine; {c['n']} paged calls held per call "
                  f"(max |err| {c['err']:.4g}); pool K/{tp} = "
                  f"{got['pool_heads']} heads a rank", flush=True)
            for i, r in enumerate(res):
                print(f"{label}: rank {i} params {r['param_gb']:.3f} GB at "
                      f"rest (whole {r['full_param_gb']:.3f}), pool "
                      f"{r['pool_gb']:.3f} GB, resident "
                      f"{r['resident_gb']:.3f} GB, peak "
                      f"{r['peak_gb']:.3f} GB; unsharded engine: params "
                      f"{want['param_gb']:.3f}, pool {want['pool_gb']:.3f}, "
                      f"resident {want['resident_gb']:.3f}, peak "
                      f"{want['peak_gb']:.3f} GB ({card})", flush=True)
            print(f"{label}: ticks {json.dumps(got['ticks'])}, mean ms "
                  f"{json.dumps({k: round(v, 3) for k, v in got['ms'].items()})}"
                  f" on the mesh ({'host-staged gloo gathers, not a speed' if backend == 'gloo' else 'nccl'}), "
                  f"unsharded {json.dumps({k: round(v, 3) for k, v in want['ms'].items()})}; "
                  f"run {got['seconds']:.2f} s vs {want['seconds']:.2f} s "
                  f"({card}); launches a rank "
                  f"{json.dumps({k: v for k, v in got['launches'].items() if v})}",
                  flush=True)
    return launches


# --------------------------------------------- phase 18: sharded training --
# steps of (a) the NCCL world of 1 and (b) the gloo world of 2 (data = 2)
MT_STEPS_ONE, MT_STEPS_TWO = 2, 2
# (b) and (d) keep MT_LAYERS of gemma2-2b's 26 layers, every width whole:
# their host-staged gloo bytes (a step's gathers and reduce-scatters, the
# reshard) shrink with the depth, so that the script stays well inside
# its 1200 s (6 until phase 21 came); (a) runs all 26
MT_LAYERS = 2
# (c): tiny gemma2-2b at S = 2048 (flash at hd 32), B = 2
MT_TINY_S, MT_TINY_B, MT_TINY_STEPS = 2048, 2, 3
MT_LR = 3e-4
# master elements sampled per leaf in (b) and (d) (every element of a
# smaller leaf)
MT_SAMPLES = 1 << 16
MT_WORLD_S = 900.0
# the bf16 rules of tests/test_torch_train_sharded.py: losses within 2**-10
# relative, grad norms within 2**-7, every master within Adam's bound (2 lr
# a step) and, after the first step (equal weights before it), within
# 1e-3 lr on 95% of elements, against the one-device run with the batch's
# rows cut as the mesh cuts them (microbatches = the data size: a rank's
# rows run the same products, and the halves' bf16 gradients are summed in
# fp32 on one device as over the ranks); against the plain one-device run,
# within those rules or twice the distance of the microbatched run from it
# (the control: what the split of a bf16 sum moves by itself). wq and wk
# scaled (QK_SCALE at full width, as in phase 16; 1/8 for the tiny model,
# as the CPU tests) so that a bf16 ulp of a weight does not flip the
# saturated softmax
MT_LOSS_RTOL, MT_NORM_RTOL, MT_FIRST_FRAC = 2.0 ** -10, 2.0 ** -7, 0.05
MT_TINY_QK = 0.125
# (c)'s make_ac(mesh, "seq_tp") run beside a dp run from the same state,
# and phase 20(b)'s; the norm scales are the one gradient seq_tp sums in
# another order (each rank's rows' share, summed over model in fp32)
MT_SEQ_STEPS = 2
# (e): one row of TRAIN_S tokens at data=2, the depth cut as (b)'s: no
# batch axis divides it, so the rules split its sequence over data
# (DataSeqRows: TRAIN_S / 2 rows a rank between sub-layers)
MT_SEQ_B = 1
# (f): one row of TRAIN_S tokens on the world of 2's second mesh, pod=2 x
# data=1 x model=1, the depth cut as (b)'s: the row splits over data (of
# one), so pod holds it whole (ActivationLayout.replicated_axes) and each
# pod rank computes it; (c)'s pod=2 x data=2 (the world of 4's second
# mesh): tiny gemma2-2b at MT_TINY_B rows (over data alone) and at one row
# (its sequence over data), each whole over pod, MT_POD_STEPS steps
MT_POD_B, MT_POD_STEPS = 1, 2
NORM_KEYS = ("ln1", "ln2", "ln1_post", "ln2_post", "ln_x", "mamba_ln",
             "final_norm", "enc_norm")


def mt_tcfg(ckpt_dir, every=0):
    """Phase 18's train config; ``every`` > 0 writes one whole checkpoint
    at the run's end (none on the way: its runs are shorter) and keeps
    only that one."""
    from repro_torch.configs import OptimConfig, TrainConfig
    return TrainConfig(optim=OptimConfig(lr=MT_LR, warmup_steps=1,
                                         total_steps=10),
                       checkpoint_dir=ckpt_dir, checkpoint_every=every,
                       keep_checkpoints=1, log_every=1)


def leaf_digest(t) -> tuple:
    """An order-sensitive fingerprint of a tensor's bits, computed on its
    device: the sum and the position-weighted sum of its elements' bit
    patterns as integers (int64, wrapping). Equal tensors give equal
    digests; a changed element changes both sums."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32, torch.int8: torch.int8}
    v = t.detach().contiguous().reshape(-1).view(ints[t.dtype])
    s1 = s2 = 0
    step = 1 << 24
    for c in range(0, v.numel(), step):
        part = v[c:c + step].long()
        w = torch.arange(c, c + part.numel(), device=v.device) % 65521 + 1
        s1 += int(part.sum())
        s2 += int((part * w).sum())
    return s1, s2


def scale_qk_state(state, f):
    """wq and wk times ``f`` (a power of two: exact, and a rank's block of
    them alike) in the parameters and in their fp32 masters, in place."""
    for tree in (state["params"], state["opt"]["master"]):
        scale_qk(attention_trees(tree), f)


def sample_index(shape):
    import torch
    n = math.prod(shape)
    return torch.linspace(0, n - 1, min(n, MT_SAMPLES),
                          dtype=torch.float64).round().long()


def block_samples(x, shape, spec, sizes, coords):
    """(the sampled flat indices of the whole leaf of ``shape`` that fall
    in this rank's block ``x`` under ``spec``, their values in fp32 on the
    host)."""
    import torch
    idx = sample_index(shape)
    multi = torch.unravel_index(idx, tuple(shape))
    keep = torch.ones(idx.shape, dtype=torch.bool)
    local = []
    for d, axes in enumerate(spec):
        n, blk = 1, 0
        for a in (() if axes is None else axes if isinstance(axes, tuple)
                  else (axes,)):
            n *= sizes[a]
            blk = blk * sizes[a] + coords[a]
        size = shape[d] // n
        keep &= (multi[d] >= blk * size) & (multi[d] < (blk + 1) * size)
        local.append(multi[d] - blk * size)
    flat = torch.zeros(idx.shape, dtype=torch.long)
    for d, m in enumerate(local):
        flat = flat * x.shape[d] + m
    flat = flat[keep]
    vals = x.reshape(-1)[flat.to(x.device)].float().cpu()
    return idx[keep], vals


def master_samples(layout, opt):
    """Each master leaf's samples on this rank (``block_samples``)."""
    from repro_torch.distributed.sharding import leaves_like
    from repro_torch.models.params import tree_leaves
    pa = layout.abstract["params"]
    return [block_samples(x, tuple(a.shape), s, layout.sizes,
                          layout.coords)
            for x, a, s in zip(tree_leaves(opt["master"]), tree_leaves(pa),
                               leaves_like(pa, layout.specs["opt"]["master"]))]


def whole_samples(opt):
    """Every master leaf's samples of a whole state."""
    from repro_torch.models.params import tree_leaves
    return [(sample_index(tuple(x.shape)), x.reshape(-1)[
        sample_index(tuple(x.shape)).to(x.device)].float().cpu())
        for x in tree_leaves(opt["master"])]


def merge_samples(ranks):
    """The ranks' samples of each leaf put together in index order; every
    sampled index must come from exactly one rank."""
    import torch
    out = []
    for parts in zip(*ranks):
        idx = torch.cat([p[0] for p in parts])
        vals = torch.cat([p[1] for p in parts])
        order = torch.argsort(idx)
        out.append((idx[order], vals[order]))
    return out


def merge_replicas(label, ranks):
    """``merge_samples`` over ranks some of which hold the same block of a
    leaf (replicas: ranks of an axis that holds the batch whole, or of
    one a leaf does not split): ranks whose samples cover the same
    indices must hold the same bits there, fatal otherwise, and count
    once. Returns the merged samples and how many leaves had replicas."""
    import torch
    out, replicated = [], 0
    for i, parts in enumerate(zip(*ranks)):
        mine = []
        for idx, vals in parts:
            twin = next((p for p in mine if torch.equal(p[0], idx)), None)
            if twin is None:
                mine.append((idx, vals))
            elif not torch.equal(twin[1], vals):
                fail(f"{label}: leaf {i}: replicas differ at "
                     f"{int((twin[1] != vals).sum())} of {idx.numel()} "
                     f"samples")
        replicated += len(mine) < len(parts)
        out.extend(merge_samples([[p] for p in mine]))
    return out, replicated


def step_distances(got, want):
    """Per step of two runs (metrics, master samples per leaf): (loss rel,
    grad norm rel, masters' max |diff|, share of masters past 1e-3 lr)."""
    import torch
    out = []
    for k, ((gm, gs), (wm, ws)) in enumerate(zip(got, want)):
        if any(not torch.equal(a[0], b[0]) for a, b in zip(gs, ws)):
            fail(f"step {k}'s samples cover other elements in two runs")
        d = torch.cat([(a[1] - b[1]).abs() for a, b in zip(gs, ws)])
        out.append((abs(gm["loss"] - wm["loss"]) / abs(wm["loss"]),
                    abs(gm["grad_norm"] - wm["grad_norm"])
                    / abs(wm["grad_norm"]), float(d.max()),
                    float((d > 1e-3 * MT_LR).float().mean())))
    return out


def hold_steps(label, got, want, lrs, control=None):
    """The bf16 rules (MT_*) on two runs' per-step metrics and master
    samples (lists of (indices, values) per leaf). With ``control`` (a
    third run of ``want``'s kind), each of the rules' distances may also
    reach twice the control's distance from ``want``. Returns a summary
    line."""
    dist = step_distances(got, want)
    ctrl = step_distances(control, want) if control else [(0.0,) * 4] * len(
        dist)
    lines, lr_sum = [], 0.0
    for k, ((el, en, dmax, frac), (cl, cn, _, cf)) in enumerate(zip(dist,
                                                                    ctrl)):
        lr_sum += lrs[k]
        gm, wm = got[k][0], want[k][0]
        lines.append(f"step {k}: loss {gm['loss']:.6f} vs {wm['loss']:.6f} "
                     f"(rel {el:.3g}), grad norm {gm['grad_norm']:.5f} vs "
                     f"{wm['grad_norm']:.5f} (rel {en:.3g}), masters max "
                     f"|diff| {dmax / MT_LR:.3g} lr, {100 * frac:.3g}% past "
                     f"1e-3 lr"
                     + (f" (control: {cl:.3g}, {cn:.3g}, {100 * cf:.3g}%)"
                        if control else ""))
        if not (el <= max(MT_LOSS_RTOL, 2 * cl)
                and en <= max(MT_NORM_RTOL, 2 * cn)):
            fail(f"{label}: step {k} loss or grad norm outside the rules: "
                 f"{lines[-1]}")
        if dmax > 2 * lr_sum * (1 + 1e-3):
            fail(f"{label}: step {k} masters past Adam's bound: {lines[-1]}")
        if k == 0 and frac > max(MT_FIRST_FRAC, 2 * cf):
            fail(f"{label}: step 0 masters: {lines[-1]}")
    return "; ".join(lines)


def mt_seq_blocks_step(model, tcfg, n):
    """The one-device train step whose gradient is the fp32 sum of the
    gradients of each of ``n`` sequence blocks' share of the loss (its
    rows' next-token losses over the whole sequence's count), each taken
    alone in the leaves' dtype (bf16): what a sequence split over ``n``
    data ranks rounds, as microbatches are for a split of the rows."""
    import torch
    from repro_torch.models import transformer as t_tr
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.training.steps import run_train_step

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        hidden = model.forward(params, batch, unembed_mode="none",
                               remat=tcfg.remat)[0]
        labels = batch["labels"]
        S = labels.shape[1]
        nxt = torch.nn.functional.pad(labels[:, 1:], (0, 1))
        w = torch.nn.functional.pad(torch.ones(
            labels[:, 1:].shape, device=labels.device), (0, 1))
        cnt = w.sum()
        total, loss = None, 0.0
        for r in range(n):
            blk = slice(r * S // n, (r + 1) * S // n)
            calls = []

            def share(v):       # chunked_ce's data_sum: the sum, then the
                calls.append(v)     # count, the whole sequence's
                return v if len(calls) == 1 else cnt
            part = t_tr.chunked_ce(params, hidden[:, blk], nxt[:, blk],
                                   model.cfg, loss_mask=w[:, blk],
                                   data_sum=share, shifted=True)
            g = torch.autograd.grad(part, leaves, retain_graph=r < n - 1)
            total = [x.float() for x in g] if total is None else [
                a.add_(b.float()) for a, b in zip(total, g)]
            loss = loss + part.detach()
            del g
        for p in leaves:
            p.requires_grad_(False)
        return loss, tree_unflatten(params, [
            t.to(p.dtype) for t, p in zip(total, leaves)])
    return run_train_step(tcfg, grad_fn, lambda g, o: adamw_update(
        g, o, tcfg.optim))


def mt_unsharded(model, shape, steps, qk, ckpt_dir, sample,
                 microbatches=1, first=0, save_to=(), seq_blocks=0):
    """The one-device port from seed 0 with wq, wk times ``qk`` (the batch
    cut into ``microbatches``) on the batches of steps ``first`` on: each
    step's metrics and its masters' samples (``sample``: whole_samples) or
    whole masters on the host. ``save_to``: checkpoint directories where
    the initial state is first written whole as the checkpoint of step
    ``first`` - 1 (a run that restores it goes on at ``first``).
    ``seq_blocks``: the step ``mt_seq_blocks_step`` of that many blocks
    instead (the control of a sequence split over data)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint.ckpt import save
    from repro_torch.data import pipeline as dp
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import steps as steps_lib
    tcfg = dataclasses.replace(mt_tcfg(ckpt_dir), microbatches=microbatches)
    state = steps_lib.init_train_state(
        model, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scale_qk_state(state, qk)
    for d in save_to:
        save(d, first - 1, state, keep=1)
    step = mt_seq_blocks_step(model, tcfg, seq_blocks) if seq_blocks \
        else steps_lib.make_train_step(model, tcfg)
    out = []
    for k in range(first, first + steps):
        state, met = step(state, dp.batch_for_model(model, shape, None, k,
                                                    "cuda", full=True))
        met = {n: float(v) for n, v in met.items()}
        out.append((met, whole_samples(state["opt"]) if sample else [
            (torch.arange(x.numel()),
             x.reshape(-1).to("cpu", torch.float32, copy=True))
            for x in tree_leaves(state["opt"]["master"])]))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mt_sharded_steps(trainer, state, model, shape, steps, sample, first=0):
    """``steps`` sharded steps on the batches of steps ``first`` on: each
    step's metrics, its flash launches on this rank, its seconds (rank 0's
    clock) and its masters' samples (``sample``) or whole masters (rank
    0)."""
    import torch
    from repro_torch.data import pipeline as dp
    from repro_torch.models.params import tree_leaves
    out = []
    for k in range(first, first + steps):
        batch = dp.batch_for_model(model, shape, None, k, "cuda", full=True)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        state, met = trainer.step(state, batch)
        met = {n: float(v) for n, v in met.items()}
        dt = trainer.first_rank_float(time.perf_counter() - t0)
        n = all_launches()["flash_attention_fwd"]
        if sample:
            masters = master_samples(trainer, state["opt"])
        else:
            whole = trainer.host_state(state)
            masters = None if whole is None else [
                (torch.arange(x.numel()), x.reshape(-1).to(torch.float32))
                for x in tree_leaves(whole["opt"]["master"])]
        out.append({"met": met, "flash": n, "s": dt, "masters": masters})
    return state, out


def mt_cut_config():
    """(b)'s and (d)'s model: gemma2-2b at full width, MT_LAYERS deep."""
    from repro_torch.configs import get_config
    return get_config("gemma2-2b").replace(num_layers=MT_LAYERS)


def mt_rank_one(rank, world, device, ckpt_dir):
    """Phase 18(a)'s rank: full-width gemma2-2b, MT_STEPS_ONE steps of
    ``train(mesh=)`` over a model=1 x data=1 NCCL mesh."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(model=1, data=1, device_type="cuda",
                             backend="nccl")
    model = build_model(get_config("gemma2-2b"))
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train(model, shape, mt_tcfg(ckpt_dir), mesh=mesh,
                num_steps=MT_STEPS_ONE, log=lambda r: None)
    launches = all_launches()
    return {"hist": [(r["loss"], r["grad_norm"]) for r in out["history"]],
            "dt": [r["dt_s"] for r in out["history"]],
            "digests": [leaf_digest(x) for x in tree_leaves(out["state"])],
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mt_rank_two(rank, world, device, ckpt_dir):
    """Phase 18's gloo world of 2 on one card: (b) full-width gemma2-2b cut
    to MT_LAYERS layers at data=2, MT_STEPS_TWO steps from seed 0 (wq, wk times QK_SCALE); (d)
    its state resharded onto rank 0 alone, then one step there through
    the sharded trainer on that one-rank mesh and, from a host copy of
    the same state, through the unsharded step; (c) tiny gemma2-2b at
    model=2 (S = 2048), MT_TINY_STEPS steps."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed.fault_tolerance import reshard_state
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.launch.mesh import make_serving_mesh, make_sub_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import steps as steps_lib
    from repro_torch.training.sharded import ShardedTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    # (b)
    t_b = time.perf_counter()
    model = build_model(mt_cut_config())
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    tcfg = mt_tcfg(ckpt_dir)
    mesh = make_serving_mesh(model=1, data=2, device_type="cuda",
                             backend="gloo")
    tr = ShardedTrainer(model, tcfg, make_ac(mesh))
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    scale_qk_state(state, QK_SCALE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    rest = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    resident = torch.cuda.memory_allocated()
    state, steps = mt_sharded_steps(tr, state, model, shape, MT_STEPS_TWO,
                                    sample=True)
    res["b"] = {"steps": steps, "rest_bytes": rest,
                "s": tr.first_rank_float(time.perf_counter() - t_b),
                "resident_gb": resident / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    # (d)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = make_sub_mesh(1, 1, device_type="cuda")
    whole = reshard_state(state, model, tcfg, one, old_mesh=mesh,
                          donate=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    reshard_s = tr.first_rank_float(time.perf_counter() - t0)
    res["d"] = None
    if whole is not None:
        samples = whole_samples(whole["opt"])
        host = [x.to("cpu", copy=True) for x in tree_leaves(whole)]
        batch = dp.batch_for_model(model, shape, None, MT_STEPS_TWO,
                                   "cuda", full=True)
        sharded = ShardedTrainer(model, tcfg, make_ac(one))
        reset_all_launches()
        whole, met_a = sharded.step(whole, batch)
        flash_a = all_launches()["flash_attention_fwd"]
        dig_a = [leaf_digest(x) for x in tree_leaves(whole)]
        for x, h in zip(tree_leaves(whole), host):
            x.copy_(h)
        del host
        whole, met_b = steps_lib.make_train_step(model, tcfg)(whole, batch)
        res["d"] = {"samples": samples, "reshard_s": reshard_s,
                    "met": [{n: float(v) for n, v in m.items()}
                            for m in (met_a, met_b)],
                    "same": dig_a == [leaf_digest(x)
                                      for x in tree_leaves(whole)],
                    "flash": flash_a, "s": time.perf_counter() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del whole
    gc.collect()
    torch.cuda.empty_cache()
    # (c) at model=2, dp and then seq_tp beside dp
    t_c = time.perf_counter()
    mesh_c = make_serving_mesh(model=2, data=1, device_type="cuda")
    res["c"] = mt_tiny(mesh_c, f"{ckpt_dir}/c2")
    res["c_s"] = time.perf_counter() - t_c
    t_c = time.perf_counter()
    res["c_seq"] = mt_seq_tp(mesh_c)
    res["c_seq_s"] = time.perf_counter() - t_c
    # (c)'s one row at data=2, which the world of 4's pod=2 x data=2
    # repeats on each pod rank
    res["c_b"] = mt_pod_tiny(mesh, labels=("B",))["B"]
    # (e) one row at data=2: the sequence split over data
    gc.collect()
    torch.cuda.empty_cache()
    res["e"] = mt_seq_data(model, tcfg, tr)
    # (f) one row at pod=2 x data=1: held whole over pod
    gc.collect()
    torch.cuda.empty_cache()
    res["f"] = mt_pod_held(model, tcfg)
    return res


def mt_pod_held(model, tcfg):
    """Phase 18(f)'s rank: MT_POD_B row of TRAIN_S tokens on a pod=2 x
    data=1 x model=1 mesh of the world of 2, the row held whole over pod
    (every rank computes it, nothing sums over pod), after the layout
    check ``train(mesh=)`` makes: the first loss and this rank's samples
    of the first gradients, then MT_STEPS_TWO steps from seed 0 with wq,
    wk times QK_SCALE (``mt_sharded_steps``: metrics, flash launches,
    seconds and masters' samples a step); the axes the step held whole,
    this rank's bytes at rest and peak."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import _check_layout
    from repro_torch.training.sharded import ShardedTrainer
    mesh = _mesh(1, 1, "cuda", MT_WORLD_S, pod=2)
    tr = ShardedTrainer(model, tcfg, make_ac(mesh))
    shape = ShapeConfig("train", TRAIN_S, MT_POD_B, "train")
    _check_layout(model, tcfg, shape, tr.ac, None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    scale_qk_state(state, QK_SCALE)
    rest = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    rows, ac = tr.rows(dp.batch_for_model(model, shape, None, 0, "cuda",
                                          full=True))
    reset_all_launches()
    loss, g = tr.grads(state["params"], rows, ac)
    first_flash = all_launches()["flash_attention_fwd"]
    grads = [block_samples(x, tuple(a.shape), s, tr.sizes, tr.coords)
             for x, a, s in zip(tree_leaves(g),
                                tree_leaves(tr.abstract["params"]),
                                tr.param_specs)]
    del g, rows
    state, steps = mt_sharded_steps(tr, state, model, shape, MT_STEPS_TWO,
                                    sample=True)
    del state
    return {"held": ac.replicated, "loss": float(loss), "grads": grads,
            "first_flash": first_flash, "steps": steps, "rest_bytes": rest,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "s": tr.first_rank_float(time.perf_counter() - t0)}


def mt_first_grads(model, shape, qk):
    """The one-device port's first loss and gradients from seed 0 (wq, wk
    times ``qk``), as the step takes them, each leaf's samples
    (``sample_index``)."""
    import torch
    from repro_torch.data import pipeline as dp
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import steps as steps_lib
    tcfg = mt_tcfg("")
    state = steps_lib.init_train_state(
        model, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scale_qk_state(state, qk)
    leaves = tree_leaves(state["params"])
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(state["params"], dp.batch_for_model(
        model, shape, None, 0, "cuda", full=True), remat=tcfg.remat)
    grads = torch.autograd.grad(loss, leaves)
    out = float(loss.detach()), [
        (sample_index(tuple(x.shape)),
         x.reshape(-1)[sample_index(tuple(x.shape)).to(x.device)]
         .float().cpu()) for x in grads]
    del state, leaves, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mt_seq_data(model, tcfg, trainer):
    """Phase 18(e)'s rank: MT_SEQ_B row of TRAIN_S tokens at data=2
    through ``trainer`` ((b)'s: the same model, mesh and state layout),
    after the layout check ``train(mesh=)`` makes (``_check_layout``: the
    rules' batch spec splits the sequence over data, ``DataSeqRows``),
    MT_STEPS_TWO steps from (b)'s initial state, seed 0 with wq, wk times
    QK_SCALE (``mt_sharded_steps``: metrics, flash launches, seconds and
    masters' samples a step); this rank's peak."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.training.loop import _check_layout
    shape = ShapeConfig("train", TRAIN_S, MT_SEQ_B, "train")
    _check_layout(model, tcfg, shape, trainer.ac, None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    scale_qk_state(state, QK_SCALE)
    state, steps = mt_sharded_steps(trainer, state, model, shape,
                                    MT_STEPS_TWO, sample=True)
    del state
    return {"steps": steps,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "s": trainer.first_rank_float(time.perf_counter() - t0)}


def mt_rank_four(rank, world, device, ckpt_dir):
    """Phase 18(c) at data=2 x model=2 (a gloo world of 4 on one card)."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import _mesh
    mesh = make_serving_mesh(model=2, data=2, device_type="cuda",
                             backend="gloo")
    out = {"c": mt_tiny(mesh, f"{ckpt_dir}/c4"), "c_seq": mt_seq_tp(mesh)}
    out["c_pod"] = mt_pod_tiny(_mesh(2, 1, "cuda", MT_WORLD_S, pod=2))
    return out


def mt_pod_tiny(mesh, labels=("A", "B")):
    """Phase 18(c)'s pod=2 x data=2 runs on ``mesh``: tiny gemma2-2b (wq,
    wk times MT_TINY_QK, S = MT_TINY_S) from seed 0, each past the layout
    check ``train(mesh=)`` makes, MT_POD_STEPS steps (whole masters on
    rank 0) of layout A, MT_TINY_B rows over data alone, on the batches
    from step 1 on (as (c)'s one-device runs take them), and of layout B,
    one row whose sequence splits over data; each held whole over pod.
    On the world of 2's data=2 mesh, B alone: the step each pod replica
    repeats. {label: (the axes the step held whole, its steps)}."""
    import torch
    from repro_torch.configs import ShapeConfig, tiny_config
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.models.api import build_model
    from repro_torch.training.loop import _check_layout
    from repro_torch.training.sharded import ShardedTrainer
    model = build_model(tiny_config("gemma2-2b"))
    tcfg = mt_tcfg("")
    out = {}
    for label, B, first in (("A", MT_TINY_B, 1), ("B", 1, 0)):
        if label not in labels:
            continue
        shape = ShapeConfig("t", MT_TINY_S, B, "train")
        tr = ShardedTrainer(model, tcfg, make_ac(mesh))
        _check_layout(model, tcfg, shape, tr.ac, None)
        held = tr.rows(dp.batch_for_model(model, shape, None, first,
                                          "cuda", full=True))[1].replicated
        state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
        scale_qk_state(state, MT_TINY_QK)
        _, steps = mt_sharded_steps(tr, state, model, shape, MT_POD_STEPS,
                                    sample=False, first=first)
        out[label] = (held, steps)
    return out


def mt_seq_tp(mesh):
    """Phase 18(c)'s seq_tp run beside dp on ``mesh``: tiny gemma2-2b
    (wq, wk times MT_TINY_QK, S = MT_TINY_S) from seed 0 through
    ``make_ac(mesh, "seq_tp")`` and through dp: the first loss, how many
    gradient leaves other than the norm scales are the same bits on this
    rank, the norm scales' largest difference over their whole leaf's max
    |g|; then MT_SEQ_STEPS steps of each (``mt_sharded_steps``: whole
    masters on rank 0)."""
    import torch
    from repro_torch.configs import ShapeConfig, tiny_config
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed.sharding import leaf_paths, make_ac
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.sharded import ShardedTrainer
    model = build_model(tiny_config("gemma2-2b"))
    shape = ShapeConfig("t", MT_TINY_S, MT_TINY_B, "train")
    b0 = dp.batch_for_model(model, shape, None, 0, "cuda", full=True)
    runs = {}
    for mode in ("dp", "seq_tp"):
        tr = ShardedTrainer(model, mt_tcfg(""), make_ac(mesh, mode))
        state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
        scale_qk_state(state, MT_TINY_QK)
        loss, g = tr.grads(state["params"], *tr.rows(b0))
        _, steps = mt_sharded_steps(tr, state, model, shape, MT_SEQ_STEPS,
                                    sample=False)
        runs[mode] = (float(loss), tree_leaves(g), steps)
    norms = [p[-1] in NORM_KEYS for p in leaf_paths(model.abstract_params())]
    (l_dp, g_dp, s_dp), (l_seq, g_seq, s_seq) = runs["dp"], runs["seq_tp"]
    same = [torch.equal(a, b) for a, b, n in zip(g_dp, g_seq, norms)
            if not n]
    rel = 0.0
    for a, b, n, spec in zip(g_dp, g_seq, norms, tr.param_specs):
        if n:
            a, b = tr.whole(a, spec).float(), tr.whole(b, spec).float()
            rel = max(rel, float((a - b).abs().max() / a.abs().max()))
    return {"loss_same": l_dp == l_seq, "same": sum(same),
            "leaves": len(same), "norms": sum(norms), "norm_rel": rel,
            "dp": s_dp, "seq_tp": s_seq}


def mt_tiny(mesh, ckpt_dir):
    """Tiny gemma2-2b (wq, wk times MT_TINY_QK) on ``mesh``:
    ``train(mesh=)`` restores the initial state that the parent wrote
    whole under ``ckpt_dir`` as the checkpoint of step 0, each rank
    slicing its blocks, runs step 1 (through ``_check_layout`` and rank
    0's clock) and writes the state whole as the checkpoint of step 1
    (rank 0 gathers it); then MT_TINY_STEPS - 1 more steps through the
    sharded trainer. Each step's record (``mt_sharded_steps``: whole
    masters on rank 0), and on rank 0 whether the checkpoint of step 1,
    the only one kept, equals the whole state after that step bit for
    bit."""
    import torch
    from repro_torch.checkpoint.ckpt import latest_step, restore
    from repro_torch.configs import ShapeConfig, tiny_config
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train
    from repro_torch.training.sharded import ShardedTrainer
    model = build_model(tiny_config("gemma2-2b"))
    shape = ShapeConfig("t", MT_TINY_S, MT_TINY_B, "train")
    reset_all_launches()
    out = train(model, shape, mt_tcfg(ckpt_dir, every=MT_TINY_STEPS + 1),
                mesh=mesh, num_steps=2, log=lambda r: None)
    flash = all_launches()["flash_attention_fwd"]
    tr = ShardedTrainer(model, mt_tcfg(ckpt_dir), make_ac(mesh))
    state = out["state"]
    whole = tr.host_state(state)
    rec, = out["history"]
    first = {"met": {k: rec[k] for k in ("loss", "grad_norm")},
             "flash": flash, "s": rec["dt_s"], "masters": None}
    saved = None
    if whole is not None:
        first["masters"] = [(torch.arange(x.numel()),
                             x.reshape(-1).to(torch.float32))
                            for x in tree_leaves(whole["opt"]["master"])]
        ckpt, step = restore(ckpt_dir, whole)
        saved = latest_step(ckpt_dir) == step == 1 and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(tree_leaves(ckpt), tree_leaves(whole)))
    _, more = mt_sharded_steps(tr, state, model, shape, MT_TINY_STEPS - 1,
                               sample=False, first=2)
    return {"steps": [first] + more, "saved": saved}


def phase_train_mesh(phase12_step_s):
    """Phase 18: training split over a mesh (training/sharded.py) on the
    card. (a) an NCCL world of 1: full-width gemma2-2b, MT_STEPS_ONE steps
    of ``train(mesh=)`` at B 2 x S 4096, losses, grad norms and every leaf
    of the state bit-identical to the unsharded ``train()`` (run here
    first), 26 x 2 flash launches a step; (b) a gloo world of 2 ranks on
    this card at data=2: full-width gemma2-2b cut to MT_LAYERS layers (wq,
    wk times QK_SCALE), MT_STEPS_TWO steps (B 1 a rank) against the
    unsharded port's under the bf16 rules (MT_*), masters sampled per
    leaf; each rank's at-rest bytes half the state's, its peak, seconds a
    step, MT_LAYERS x 2 flash launches a step a rank; (c) tiny gemma2-2b at S = 2048 at model=2 and data=2 x
    model=2 (a gloo world of 4), MT_TINY_STEPS steps against the unsharded
    port (in 2 microbatches at data=2, and then plain) under the same
    rules, the first step through ``train(mesh=)`` from a whole
    checkpoint of the initial state written here, which writes its own
    whole checkpoint (``mt_tiny``); (d) (b)'s state resharded onto one rank
    (``reshard_state``): its masters equal (b)'s at every sample, and one
    step there through the sharded trainer bit-identical to the unsharded
    step from the same state. Returns the flash launches of the sharded
    runs, summed over ranks, and (b)'s bytes at rest on each rank."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config, tiny_config
    from repro_torch.launch.mesh import WorldFailed, spawn
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train
    from repro_torch.training.steps import abstract_train_state

    card = card_line()
    model = build_model(get_config("gemma2-2b"))
    cut = build_model(mt_cut_config())
    tiny = build_model(tiny_config("gemma2-2b"))
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    tiny_shape = ShapeConfig("t", MT_TINY_S, MT_TINY_B, "train")
    seq_shape = ShapeConfig("train", TRAIN_S, MT_SEQ_B, "train")
    state_bytes = sum(math.prod(a.shape) * a.element_size() for a in
                      tree_leaves(abstract_train_state(cut, mt_tcfg(""))))
    flash = 0
    with tempfile.TemporaryDirectory() as tmp:
        # (a): the unsharded run, then the world of 1
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = train(model, shape, mt_tcfg(tmp), device="cuda",
                    num_steps=MT_STEPS_ONE, log=lambda r: None)
        want = [(r["loss"], r["grad_norm"]) for r in out["history"]]
        want_dt = [r["dt_s"] for r in out["history"]]
        digests = [leaf_digest(x) for x in tree_leaves(out["state"])]
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        del out
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter()
        try:
            a, = spawn(mt_rank_one, 1, backend="nccl", device="cuda:0",
                       timeout_s=MT_WORLD_S, args=(tmp,))
        except WorldFailed as e:
            fail(f"mesh-train[a]: the NCCL world of 1 failed:\n{e}")
        if a["hist"] != want or a["digests"] != digests:
            fail(f"mesh-train[a]: train(mesh=<world of 1>) not bit-identical "
                 f"to train(): history {a['hist']} vs {want}; "
                 f"{sum(x != y for x, y in zip(a['digests'], digests))} of "
                 f"{len(digests)} leaves differ")
        n = a["launches"]["flash_attention_fwd"]
        if n != 26 * 2 * MT_STEPS_ONE:
            fail(f"mesh-train[a]: {n} flash launches, expected "
                 f"{26 * 2 * MT_STEPS_ONE}")
        flash += n
        print(f"mesh-train[a nccl world of 1, gemma2-2b B={TRAIN_B} "
              f"S={TRAIN_S}]: {MT_STEPS_ONE} steps bit-identical to the "
              f"unsharded train() (losses, grad norms and all "
              f"{len(digests)} leaves); steps {', '.join(f'{x:.3f}' for x in a['dt'])} s"
              f" on the mesh vs {', '.join(f'{x:.3f}' for x in want_dt)} s "
              f"unsharded (phase 12's median {phase12_step_s:.3f} s); peak "
              f"{a['peak_gb']:.2f} GB vs {peak:.2f} GB unsharded; {n} flash "
              f"launches; world {time.perf_counter() - t_a:.1f} s ({card})",
              flush=True)
        mark("phase 18's NCCL world of 1")
        # (b), (c): the unsharded baselines, then the gloo worlds
        t_b = time.perf_counter()
        want_b = {m: mt_unsharded(cut, shape, MT_STEPS_TWO, QK_SCALE, tmp,
                                  sample=True, microbatches=m)
                  for m in (1, 2)}
        want_c = {m: mt_unsharded(tiny, tiny_shape, MT_TINY_STEPS,
                                  MT_TINY_QK, tmp, sample=False,
                                  microbatches=m, first=1,
                                  save_to=(f"{tmp}/c2", f"{tmp}/c4")
                                  if m == 1 else ()) for m in (1, 2)}
        # (c)'s pod=2 x data=2 run at one row: plain, and the two sequence
        # blocks' bf16 gradients summed in fp32 (as (e))
        want_pod = {n: mt_unsharded(tiny, ShapeConfig(
            "t", MT_TINY_S, 1, "train"), MT_POD_STEPS, MT_TINY_QK, tmp,
            sample=False, seq_blocks=0 if n == 1 else n) for n in (1, 2)}
        base_s = time.perf_counter() - t_b
        # (e)'s one-device runs, on the card beside the host-staged world
        # of 2 (a rank's peak 12.7 GB in a rehearsal)
        pool = concurrent.futures.ThreadPoolExecutor(1)

        def e_baselines():
            t_e = time.perf_counter()
            runs = {n: mt_unsharded(cut, seq_shape, MT_STEPS_TWO, QK_SCALE,
                                    tmp, sample=True,
                                    seq_blocks=0 if n == 1 else n)
                    for n in (1, 2)}
            # (f)'s first loss and gradients (its steps are runs[1]'s)
            runs["first"] = mt_first_grads(cut, seq_shape, QK_SCALE)
            return runs, time.perf_counter() - t_e
        e_future = pool.submit(e_baselines)
        # (c)'s tiny world of 4 beside (b)'s host-staged world of 2
        worlds_pool = concurrent.futures.ThreadPoolExecutor(2)

        def world(fn, n_ranks):
            t0 = time.perf_counter()
            try:
                res = spawn(fn, n_ranks, backend="gloo", device="cuda:0",
                            timeout_s=MT_WORLD_S, args=(tmp,))
            except WorldFailed as e:
                fail(f"mesh-train: the gloo world of {n_ranks} failed:\n{e}")
            return res, time.perf_counter() - t0
        futures = {n: worlds_pool.submit(world, fn, n)
                   for fn, n in ((mt_rank_two, 2), (mt_rank_four, 4))}
        worlds = {}
        with worlds_pool:
            for n_ranks in (4, 2):
                worlds[n_ranks], world_s = futures[n_ranks].result()
                print(f"mesh-train: gloo world of {n_ranks} on cuda:0 in "
                      f"{world_s:.1f} s, beside the world of "
                      f"{6 - n_ranks}", flush=True)
                mark(f"phase 18's gloo world of {n_ranks}")
        with pool:
            want_e, base_e_s = e_future.result()
    two, four = worlds[2], worlds[4]
    lrs = [m["lr"] for m, _ in want_b[1]]
    # (b)
    b = [r["b"] for r in two]
    got = [(s["met"], merge_samples([r["steps"][k]["masters"] for r in b])
            ) for k, s in enumerate(b[0]["steps"])]
    line = hold_steps("mesh-train[b] vs 2 microbatches", got, want_b[2], lrs)
    line1 = hold_steps("mesh-train[b] vs unsharded", got, want_b[1], lrs,
                       control=want_b[2])
    for i, r in enumerate(b):
        for k, s in enumerate(r["steps"]):
            if s["flash"] != MT_LAYERS * 2:
                fail(f"mesh-train[b]: rank {i} step {k}: {s['flash']} flash "
                     f"launches, expected {MT_LAYERS * 2}")
            flash += s["flash"]
        if r["rest_bytes"] - 4 != (state_bytes - 4) // 2:
            fail(f"mesh-train[b]: rank {i} holds {r['rest_bytes']} bytes at "
                 f"rest, not half of {state_bytes}")
    print(f"mesh-train[b gloo data=2, gemma2-2b {MT_LAYERS} of 26 layers "
          f"B={TRAIN_B} S={TRAIN_S}, wq, wk x {QK_SCALE}]: against the one-device run in 2 microbatches:"
          f" {line}; against the unsharded run (the control: the 2-"
          f"microbatch run): {line1}; unsharded baselines {base_s:.1f} s",
          flush=True)
    for i, r in enumerate(b):
        print(f"mesh-train[b]: rank {i} state at rest "
              f"{r['rest_bytes'] / 1e9:.3f} GB of the unsharded "
              f"{state_bytes / 1e9:.3f} GB, resident "
              f"{r['resident_gb']:.3f} GB, peak {r['peak_gb']:.3f} GB; steps "
              f"{', '.join(f'{s['s']:.2f}' for s in r['steps'])} s "
              f"(host-staged gloo, not a speed); flash launches a step "
              f"{[s['flash'] for s in r['steps']]} ({card})", flush=True)
    print(f"mesh-train[b]: the two ranks' peaks sum to "
          f"{sum(r['peak_gb'] for r in b):.2f} GB", flush=True)
    # (d)
    d = two[0]["d"]
    if two[1]["d"] is not None:
        fail("mesh-train[d]: rank 1 did not drop out of the one-rank mesh")
    last = got[-1][1]
    if any(not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]))
           for x, y in zip(d["samples"], last)):
        fail("mesh-train[d]: the resharded masters differ from (b)'s")
    if not d["same"] or d["met"][0] != d["met"][1]:
        fail(f"mesh-train[d]: the step on the one-rank mesh differs from "
             f"the unsharded step from the same state: {d['met']}")
    flash += d["flash"]
    print(f"mesh-train: world of 2: (b) {b[0]['s']:.1f} s, (d) "
          f"{d['s']:.1f} s, (c) {two[0]['c_s']:.1f} s", flush=True)
    print(f"mesh-train[d]: data=2 -> one rank in {d['reshard_s']:.1f} s "
          f"(gloo, {state_bytes / 1e9:.3f} GB of state), masters equal to (b)'s at every sample; one step there "
          f"(loss {d['met'][0]['loss']:.6f}, grad norm "
          f"{d['met'][0]['grad_norm']:.5f}) bit-identical to the unsharded "
          f"step from the same state; peak {d['peak_gb']:.2f} GB; "
          f"{d['flash']} flash launches", flush=True)
    # (c)
    tiny_lrs = [m["lr"] for m, _ in want_c[1]]
    for label, ranks, data in (("model=2", two, 1),
                               ("data=2 x model=2", four, 2)):
        if ranks[0]["c"]["saved"] is not True:
            fail(f"mesh-train[c {label}]: the whole checkpoint of step 1 "
                 f"that train(mesh=) wrote differs from the state")
        steps = [r["c"]["steps"] for r in ranks]
        got = [(s["met"], s["masters"]) for s in steps[0]]
        line = hold_steps(f"mesh-train[c {label}]", got, want_c[data],
                          tiny_lrs)
        if data > 1:
            line += "; against the unsharded run: " + hold_steps(
                f"mesh-train[c {label}] vs unsharded", got, want_c[1],
                tiny_lrs, control=want_c[data])
        for i, r in enumerate(steps):
            for s in r:
                if s["flash"] != tiny.cfg.num_layers * 2:
                    fail(f"mesh-train[c {label}]: rank {i}: {s['flash']} "
                         f"flash launches a step")
                flash += s["flash"]
        print(f"mesh-train[c {label}, tiny gemma2-2b B={MT_TINY_B} "
              f"S={MT_TINY_S}, wq, wk x {MT_TINY_QK}]: train(mesh=) restored "
              f"step 0 from a whole checkpoint, ran step 1 and wrote it "
              f"whole, equal to the state bit for bit; then "
              f"{MT_TINY_STEPS - 1} steps through the trainer: {line}",
              flush=True)
        # seq_tp beside dp, from the same state in the same world
        q = [r["c_seq"] for r in ranks]
        for i, r in enumerate(q):
            for s in r["dp"] + r["seq_tp"]:
                if s["flash"] != tiny.cfg.num_layers * 2:
                    fail(f"mesh-train[c {label} seq_tp]: rank {i}: "
                         f"{s['flash']} flash launches a step")
                flash += s["flash"]
        got, want = ([(s["met"], s["masters"]) for s in q[0][m]]
                     for m in ("seq_tp", "dp"))
        line = hold_steps(f"mesh-train[c {label} seq_tp]", got, want,
                          [m["lr"] for m, _ in want])
        print(f"mesh-train[c {label} seq_tp, tiny gemma2-2b B={MT_TINY_B} "
              f"S={MT_TINY_S}]: make_ac(mesh, 'seq_tp') against dp from the "
              f"same state: first loss bit-identical "
              f"{[r['loss_same'] for r in q]} (rank by rank); gradient "
              f"leaves other than the {q[0]['norms']} norm scales "
              f"bit-identical {[r['same'] for r in q]} of {q[0]['leaves']}; "
              f"the norm scales' largest difference "
              f"{max(r['norm_rel'] for r in q):.3g} of a leaf's max |g|; "
              f"{MT_SEQ_STEPS} steps against dp's under the bf16 rules: "
              f"{line}", flush=True)
    print(f"mesh-train: (c)'s seq_tp runs {two[0]['c_seq_s']:.1f} s in the "
          f"world of 2", flush=True)
    flash += mt_hold_pod_tiny([r["c_pod"] for r in four], want_c, want_pod,
                              [r["c_b"] for r in two], tiny.cfg.num_layers)
    flash += mt_hold_seq_data([r["e"] for r in two], want_e, base_e_s,
                              card)
    flash += mt_hold_pod_held([r["f"] for r in two], want_e, state_bytes,
                              card)
    return flash, [r["rest_bytes"] for r in b]


def mt_hold_pod_tiny(ranks, want_c, want_pod, data2, layers):
    """Phase 18(c) at pod=2 x data=2: every rank's metrics the same bits
    at every step (each pod replica computes its own loss and sums over
    data alone). Under phase 18's bf16 rules, A against the one-device
    run in 2 microbatches (the rows as data cuts them), and against the
    plain run within the rules or twice that control's distance. B
    against ``data2`` (the same row at data=2, whose step each pod
    replica repeats: its first loss the same bits, fatal otherwise, its
    steps under the rules, the grad norm's partial sums grouped
    otherwise), and against the plain run within the rules or twice the
    distance of the run summing the two sequence blocks' bf16 gradients
    in fp32 (phase 18(e)'s control). Each rank ``layers`` x 2 flash
    launches a step. Returns the flash launches, summed over ranks."""
    flash = 0
    for label, plain, split in (("A", want_c[1], want_c[2]),
                                ("B", want_pod[1], want_pod[2])):
        tag = f"mesh-train[c pod=2 x data=2 {label}]"
        runs = [r[label] for r in ranks]
        for i, (held, steps) in enumerate(runs):
            if held != ("pod",):
                fail(f"{tag}: rank {i}'s step held {held} whole, not pod")
            if [s["met"] for s in steps] != [s["met"] for s in runs[0][1]]:
                fail(f"{tag}: rank {i}'s metrics differ from rank 0's")
            for s in steps:
                if s["flash"] != layers * 2:
                    fail(f"{tag}: rank {i}: {s['flash']} flash launches a "
                         f"step")
                flash += s["flash"]
        got = [(s["met"], s["masters"]) for s in runs[0][1]]
        n = len(got)
        lrs = [m["lr"] for m, _ in plain[:n]]
        if label == "A":
            line = "against the one-device run in 2 microbatches: " + \
                hold_steps(tag, got, split[:n], lrs)
            rows = f"B={MT_TINY_B}, its rows over data alone"
        else:
            for i, (_, steps) in enumerate(data2):
                for s in steps:
                    if s["flash"] != layers * 2:
                        fail(f"{tag}: data=2 rank {i}: {s['flash']} flash "
                             f"launches a step")
                    flash += s["flash"]
            held, steps = data2[0]
            if held != () or steps[0]["met"]["loss"] != got[0][0]["loss"]:
                fail(f"{tag}: the first loss {got[0][0]['loss']} is not "
                     f"data=2's {steps[0]['met']['loss']} (held {held})")
            line = "against the same row at data=2 (first loss the same " \
                "bits): " + hold_steps(
                    f"{tag} vs data=2", got,
                    [(s["met"], s["masters"]) for s in steps], lrs)
            rows = "B=1, its sequence over data"
        line1 = hold_steps(f"{tag} vs unsharded", got, plain[:n], lrs,
                           control=split[:n])
        what = "the 2-microbatch run" if label == "A" else \
            "the run summing the two sequence blocks' bf16 gradients"
        print(f"{tag}, tiny gemma2-2b {rows} S={MT_TINY_S}, whole over pod]:"
              f" the 4 ranks' metrics the same bits at every step; {line}; "
              f"against the plain run (the control: {what}): {line1}",
              flush=True)
    return flash


def mt_hold_pod_held(ranks, want, state_bytes, card):
    """Phase 18(f): the two pod ranks' first losses and every step's
    metrics the same bits, and their sampled first gradients and masters
    (``merge_replicas``); the first loss and gradients against the
    one-device run's (bit-identity printed; the loss within phase 18's
    loss rule), the steps under phase 18's bf16 rules against the
    one-device run (the row is one device's on each pod rank: no batch
    split rounds a sum); each rank MT_LAYERS x 2 flash launches a step
    and in the first gradients, its state at rest half the whole's.
    Returns the flash launches, summed over ranks."""
    import torch
    label = "mesh-train[f]"
    for i, r in enumerate(ranks):
        if r["held"] != ("pod",):
            fail(f"{label}: rank {i}'s step held {r['held']} whole, not pod")
        seen = [(x["loss"], [s["met"] for s in x["steps"]]) for x in ranks]
        if seen[i] != seen[0]:
            fail(f"{label}: the pod ranks' losses or metrics differ: {seen}")
        if r["rest_bytes"] - 4 != (state_bytes - 4) // 2:
            fail(f"{label}: rank {i} holds {r['rest_bytes']} bytes at rest, "
                 f"not half of {state_bytes}")
    grads, _ = merge_replicas(f"{label} first gradients",
                              [r["grads"] for r in ranks])
    w_loss, w_grads = want["first"]
    if any(not torch.equal(a[0], b[0]) for a, b in zip(grads, w_grads)):
        fail(f"{label}: the gradient samples cover other elements than the "
             f"one-device run's")
    same = ranks[0]["loss"] == w_loss and all(
        torch.equal(a[1], b[1]) for a, b in zip(grads, w_grads))
    rel = max(float((a[1] - b[1]).abs().max() / b[1].abs().max().clamp(
        min=1e-30)) for a, b in zip(grads, w_grads))
    if abs(ranks[0]["loss"] - w_loss) > MT_LOSS_RTOL * abs(w_loss):
        fail(f"{label}: first loss {ranks[0]['loss']} vs the one-device "
             f"{w_loss}")
    got, shared = [], 0
    for k, s in enumerate(ranks[0]["steps"]):
        masters, n = merge_replicas(f"{label} step {k} masters",
                                    [r["steps"][k]["masters"]
                                     for r in ranks])
        shared = max(shared, n)
        got.append((s["met"], masters))
    line = hold_steps(f"{label} vs unsharded", got, want[1],
                      [m["lr"] for m, _ in want[1]])
    flash = 0
    for i, r in enumerate(ranks):
        for k, s in enumerate(r["steps"]):
            if s["flash"] != MT_LAYERS * 2:
                fail(f"{label}: rank {i} step {k}: {s['flash']} flash "
                     f"launches, expected {MT_LAYERS * 2}")
            flash += s["flash"]
        if r["first_flash"] != MT_LAYERS * 2:
            fail(f"{label}: rank {i}: {r['first_flash']} flash launches in "
                 f"the first gradients")
        flash += r["first_flash"]
    same = "bit-identical" if same else "not bit-identical"
    print(f"mesh-train[f gloo pod=2 x data=1, gemma2-2b {MT_LAYERS} of 26 "
          f"layers B={MT_POD_B} S={TRAIN_S}, the row whole over pod, wq, wk x "
          f"{QK_SCALE}]: the pod ranks' first losses, metrics and sampled "
          f"gradients and masters the same bits ({shared} of "
          f"{len(got[0][1])} master leaves held alike on both, the others "
          f"split over pod); the first loss and gradients against the "
          f"one-device run's: {same} (loss {ranks[0]['loss']:.6f} vs {w_loss:.6f}, gradient samples "
          f"within {rel:.3g} of a leaf's max); {MT_STEPS_TWO} steps against "
          f"the one-device run: {line}", flush=True)
    for i, r in enumerate(ranks):
        print(f"{label}: rank {i} state at rest "
              f"{r['rest_bytes'] / 1e9:.3f} GB of the unsharded "
              f"{state_bytes / 1e9:.3f} GB, peak {r['peak_gb']:.3f} GB; "
              f"steps {', '.join(f'{s['s']:.2f}' for s in r['steps'])} s "
              f"(host-staged gloo, not a speed); flash launches a step "
              f"{[s['flash'] for s in r['steps']]}; {r['s']:.1f} s "
              f"({card})", flush=True)
    return flash


def mt_hold_seq_data(ranks, want, base_s, card):
    """Phase 18(e): the ranks' steps on one row at data=2 against the
    one-device run whose gradient sums the two sequence blocks' bf16
    gradients in fp32 (``mt_seq_blocks_step``) under phase 18's bf16
    rules (MT_*; losses, grad norms, masters), and against the plain
    one-device run within them or twice the block run's distance; each
    rank MT_LAYERS x 2 flash launches a step over the whole TRAIN_S rows
    (the forward and remat's recompute). Returns the flash launches,
    summed over ranks."""
    got = [(s["met"], merge_samples([r["steps"][k]["masters"]
                                     for r in ranks]))
           for k, s in enumerate(ranks[0]["steps"])]
    lrs = [m["lr"] for m, _ in want[1]]
    line = hold_steps("mesh-train[e] vs the sequence-block run", got,
                      want[2], lrs)
    line1 = hold_steps("mesh-train[e] vs unsharded", got, want[1], lrs,
                       control=want[2])
    flash = 0
    for i, r in enumerate(ranks):
        for k, s in enumerate(r["steps"]):
            if s["flash"] != MT_LAYERS * 2:
                fail(f"mesh-train[e]: rank {i} step {k}: {s['flash']} flash "
                     f"launches, expected {MT_LAYERS * 2}")
            flash += s["flash"]
    print(f"mesh-train[e gloo data=2, gemma2-2b {MT_LAYERS} of 26 layers "
          f"B={MT_SEQ_B} S={TRAIN_S}, the sequence split over data "
          f"({TRAIN_S // 2} rows a rank), wq, wk x {QK_SCALE}]: against the "
          f"one-device run summing the two sequence blocks' bf16 gradients "
          f"in fp32: {line}; against the unsharded run (the control: the "
          f"block run): {line1}; one-device runs {base_s:.1f} s, beside the "
          f"world", flush=True)
    for i, r in enumerate(ranks):
        print(f"mesh-train[e]: rank {i} peak {r['peak_gb']:.3f} GB; steps "
              f"{', '.join(f'{s['s']:.2f}' for s in r['steps'])} s "
              f"(host-staged gloo, not a speed); flash launches a step "
              f"{[s['flash'] for s in r['steps']]} (forward and remat "
              f"recompute over the whole {TRAIN_S} rows, {MT_LAYERS} "
              f"layers); {r['s']:.1f} s ({card})", flush=True)
    return flash


# ------------------------------------------------------------- dry-run ----
DRY_JOBS = 1            # phase 19(c)'s cells at once, a process each
DRY_TIMEOUT_S = 600.0
# phase 19(c)'s cells: every assigned cell of the dense and moe families
# (19, the moe cells at data > 1 among them) and one of each of the ssm,
# hybrid, encdec and vlm families (the other 10 run in the CLI's own
# --all, as tests/test_torch_dryrun.py holds their state bytes), then
# decode cells on stored weights, one sweep a --quant mode
DRY_FAMILY_CELLS = (("mamba2-370m", "decode_32k"), ("zamba2-1.2b",
                                                    "long_500k"),
                    ("whisper-large-v3", "decode_32k"),
                    ("llava-next-mistral-7b", "train_4k"))
DRY_RAN = 23
DRY_QUANT = ("w4", "haq")
DRY_QUANT_CELLS = (("gemma2-2b", "decode_32k"),
                   ("llama4-maverick-400b-a17b", "decode_32k"))
# and these two under --ac-mode seq_tp, each printed beside its dp record
DRY_SEQ_TP_CELLS = (("gemma2-2b", "train_4k"), ("gemma2-2b", "prefill_32k"))
# and train_4k on the two-pod mesh in microbatches that pod x data (32)
# does not divide: rows over data alone (M 16, 16 rows) or the sequence
# over data (M 32, 8 rows), each held whole over pod; {M: archs}
DRY_MICRO_CELLS = {16: ("gemma2-2b", "granite-moe-3b-a800m"),
                   32: ("gemma2-2b",)}
H100_BF16_FLOPS = 989e12


def dry_cells():
    """Phase 19(c)'s cells, as ``--cells`` takes them."""
    from repro_torch.configs import assigned_cells, get_config
    return [(a, s) for a, s in assigned_cells()
            if get_config(a).family in ("dense", "moe")
            or (a, s) in DRY_FAMILY_CELLS]


def dry_runs():
    """Phase 19(c)'s sweep, as the dry-run CLI's arguments: ``dry_cells``
    on the single-pod mesh, then DRY_QUANT_CELLS a mode of DRY_QUANT, then
    DRY_SEQ_TP_CELLS under seq_tp."""
    return [["--mesh", "single", "--cells",
             ",".join(f"{a}:{s}" for a, s in dry_cells())]] + [
        ["--mesh", "single", "--cells",
         ",".join(f"{a}:{s}" for a, s in DRY_QUANT_CELLS), "--quant", q,
         "--tag", f"_{q}"] for q in DRY_QUANT] + [
        ["--mesh", "single", "--cells",
         ",".join(f"{a}:{s}" for a, s in DRY_SEQ_TP_CELLS), "--ac-mode",
         "seq_tp"]]


def dry_micro_runs():
    """Phase 19(c)'s two-pod microbatched cells (DRY_MICRO_CELLS), as the
    dry-run CLI's arguments."""
    return [["--mesh", "multi", "--cells",
             ",".join(f"{a}:train_4k" for a in archs), "--microbatches",
             str(m), "--tag", f"_m{m}"]
            for m, archs in DRY_MICRO_CELLS.items()]


class DrySweep:
    """Dry-run CLI runs (``python -m repro_torch.launch.dryrun --force
    --jobs DRY_JOBS`` with each of ``runs``' arguments, one after the
    other) in a subprocess of its own, at ``nice``, one cell at a time, on
    one host core, collected by ``result``. Phase 19(c)'s ``dry_runs``
    start after phase 16 and trace while phases 17-22 run (two at once
    slowed phases 17-18's host-staged gloo worlds), so they share the host
    with no phase that times an eager loop on one process alone; its
    ``dry_micro_runs`` (about 300 s of tracing on an 8-core host, more
    than those phases leave the sweep) start after phase 1 at nice 19,
    beside phases 1b-16, whose loops run on one process. Both are
    collected after phase 23(b), and stopped at exit whatever happens in
    between."""

    def __init__(self, runs, nice=0):
        import atexit
        import os
        import shlex
        self.dir = tempfile.TemporaryDirectory()
        head = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
                "--jobs", str(DRY_JOBS), "--out-dir", self.dir.name]
        self.proc = subprocess.Popen(
            ["/bin/sh", "-c", " && ".join(shlex.join(head + r)
                                          for r in runs)],
            cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, preexec_fn=lambda: os.nice(nice))
        self.t0 = time.perf_counter()
        atexit.register(self.stop)

    def result(self):
        """(exit code, output, seconds since the start)."""
        out, _ = self.proc.communicate(timeout=DRY_TIMEOUT_S)
        return self.proc.returncode, out, time.perf_counter() - self.t0

    def stop(self) -> None:
        """Kill the sweep's process group (its cell workers too)."""
        import os
        import signal
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.dir.cleanup()


def phase_dryrun(step_s: float, peak_bytes: int, rest_bytes: list) -> None:
    """Phase 19 (a) and (b): the dry-run's counted step beside phase 12's
    and phase 18(b)'s measurements (the module docstring)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import specs_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh, dry_world
    from repro_torch.models.api import build_model
    from repro_torch.training.steps import (abstract_train_state,
                                            train_state_logical_specs)

    card = card_line()
    # (a)
    model = build_model(get_config("gemma2-2b"))
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    with dry_world(1):
        rec = dryrun.cell_record(model, shape, _mesh(1, 1, "cpu", 60.0),
                                 dryrun.train_cfg_for("gemma2-2b"), chips=1)
    r = rec["roofline"]
    mfu = r["model_flops"] / (step_s * H100_BF16_FLOPS)
    live = rec["live_bytes_per_device"]
    print(f"dryrun[a gemma2-2b B={TRAIN_B} S={TRAIN_S}, one card]: "
          f"t_compute {r['t_compute_s']:.4f} s, t_memory "
          f"{r['t_memory_s']:.4f} s, {r['bottleneck']}-bound, dot FLOPs "
          f"{rec['dot_flops_per_device']:.4e}, model_flops "
          f"{r['model_flops']:.4e} (useful share "
          f"{r['useful_flops_ratio']:.3f}); phase 12's median step "
          f"{step_s:.3f} s: MFU {mfu:.4f}, {r['t_compute_s'] / step_s:.3f} of "
          f"the step at the compute bound; predicted live peak "
          f"{live / 1e9:.2f} GB vs phase 12's max_memory_allocated "
          f"{peak_bytes / 1e9:.2f} GB (ratio {live / peak_bytes:.3f}); traced "
          f"in {rec['trace_s']:.1f} s ({card})", flush=True)
    # (b)
    cut = build_model(mt_cut_config())
    tcfg = mt_tcfg("")
    sizes = {"data": 2, "model": 1}
    abstract = abstract_train_state(cut, tcfg)
    want = dryrun.sharded_bytes_per_device(
        abstract, specs_for(abstract, train_state_logical_specs(cut, tcfg),
                            sizes), sizes)
    if not rest_bytes or any(b != want for b in rest_bytes):
        fail(f"dryrun[b]: phase 18(b)'s state at rest per rank "
             f"{rest_bytes} bytes, the dry-run's {want}")
    print(f"dryrun[b gemma2-2b {MT_LAYERS} layers, data=2]: "
          f"sharded_bytes_per_device {want} bytes, equal to each rank's "
          f"measured state at rest {rest_bytes}", flush=True)


def phase_dryrun_sweep(sweep: DrySweep, micro: DrySweep) -> None:
    """Phase 19(c): ``sweep``'s and ``micro``'s cells, each run, none
    refused (the module docstring)."""
    rc, out, secs = sweep.result()
    rc_m, out_m, secs_m = micro.result()
    pairs = {}
    for a, sh in DRY_SEQ_TP_CELLS:
        paths = [Path(sweep.dir.name) / f"{a}__{sh}__single{t}.json"
                 for t in ("", "_seq_tp")]
        if all(p.exists() for p in paths):
            pairs[(a, sh)] = [json.loads(p.read_text()) for p in paths]
    sweep.stop()
    both = f"{out}\n{out_m}"
    for line in both.splitlines():
        if line.startswith(("[ok", "[FAIL]", "[refused]")) \
                or "cells ran" in line:
            print(f"dryrun[c] {line}", flush=True)
    print(f"dryrun[c] --cells (the dense and moe families' and "
          f"{', '.join(f'{a} {s}' for a, s in DRY_FAMILY_CELLS)}) --mesh "
          f"single, then --quant {' and '.join(DRY_QUANT)} on "
          f"{', '.join(f'{a} {s}' for a, s in DRY_QUANT_CELLS)}, "
          f"{DRY_JOBS} cells at once, started after phase 16 and collected "
          f"{secs:.1f} s later; the two-pod cells started after phase 1 "
          f"and collected {secs_m:.1f} s later", flush=True)
    if rc != 0 or rc_m != 0:
        fail(f"dryrun[c]: the sweeps exited {rc} and {rc_m}:\n"
             f"{out[-2000:]}\n{out_m[-2000:]}")
    want = [f"{DRY_RAN} cells ran, 0 refused, 0 failed"] + [
        f"{len(DRY_QUANT_CELLS)} cells ran, 0 refused, 0 failed"] \
        * len(DRY_QUANT) + [
        f"{len(DRY_SEQ_TP_CELLS)} cells ran, 0 refused, 0 failed"] + [
        f"{len(archs)} cells ran, 0 refused, 0 failed"
        for archs in DRY_MICRO_CELLS.values()]
    got = [line.split(" in ")[0] for line in both.splitlines()
           if line[:1].isdigit() and " cells ran, " in line]
    if got != want:
        fail(f"dryrun[c]: want {want} (7 train, 16 serving; then the "
             f"--quant, the seq_tp and the microbatched two-pod cells), got "
             f"{got}:\n{both[-4000:]}")
    for m, archs in DRY_MICRO_CELLS.items():
        for a in archs:
            rec = json.loads((Path(micro.dir.name) /
                              f"{a}__train_4k__multi_m{m}.json").read_text())
            print(f"dryrun[c {a} train_4k pod 2 x 16 x 16, {m} microbatches "
                  f"of {256 // m} rows, whole over pod]: live "
                  f"{rec['live_bytes_per_device'] / 2**30:.2f} GiB a device, "
                  f"state {rec['state_bytes_per_device'] / 2**30:.2f} GiB, "
                  f"dot FLOPs {rec['dot_flops_per_device']:.4e}, traced in "
                  f"{rec['trace_s']:.1f} s", flush=True)
    micro.stop()

    def coll(rec):
        return sum(v for k, v in rec["collectives_per_device"].items()
                   if k != "coll_count") / 1e9
    for (a, sh), (dp, seq) in pairs.items():
        r0, r1 = dp["roofline"], seq["roofline"]
        print(f"dryrun[c {a} {sh} 16 x 16] dp / seq_tp: live "
              f"{dp['live_bytes_per_device'] / 2**30:.2f} / "
              f"{seq['live_bytes_per_device'] / 2**30:.2f} GiB, collective "
              f"{coll(dp):.2f} / {coll(seq):.2f} GB (all-gather "
              f"{dp['collectives_per_device'].get('all-gather', 0) / 1e9:.2f}"
              f" / {seq['collectives_per_device'].get('all-gather', 0) / 1e9:.2f}"
              f"), t_collective {r0['t_collective_s']:.4f} / "
              f"{r1['t_collective_s']:.4f} s, t_compute "
              f"{r0['t_compute_s']:.4f} / {r1['t_compute_s']:.4f} s, "
              f"{r0['bottleneck']} / {r1['bottleneck']}-bound", flush=True)
    if len(pairs) != len(DRY_SEQ_TP_CELLS):
        fail(f"dryrun[c]: the seq_tp cells' records beside dp's: "
             f"{sorted(pairs)}")


# ------------------------------------- phase 20: serving over a mesh ----
# (a) and (b): B 2 x a 4096-token prompt (flash), then 4 decode steps from
# position 4096, where gemma2-2b's 4096-slot rings wrap, over caches grown
# to 4100 slots (a length model=2 divides); (b) keeps MS_LAYERS of the 26
# layers, every width whole, as phases 17-18's gloo runs do (16 steps at 6
# layers until phase 21 came: (b)'s host-staged steps took 3 s each)
MS_B, MS_S, MS_STEPS = 2, 4096, 4
MS_LAYERS = 2
# (c): tiny gemma2-2b (window 32) over 2048 tokens (flash at hd 32), 8
# steps from position 2048, where its 32-slot rings wrap, caches grown to
# 2056 slots (model=2 and model=4 divide them)
MS_TINY_S, MS_TINY_STEPS = 2048, 8
MS_WORLD_S = 600.0
MS_AUTOTUNE = ["--arch", "gemma2-2b", "--tiny", "--requests", "4",
               "--prompt-len", "24", "--gen", "8", "--max-batch", "4",
               "--autotune", "8"]


def ms_inputs(cfg, B, S, steps, seed):
    """A prompt (B, S) and the token fed at each decode step (B, steps),
    int32 on the host, from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(2, cfg.vocab_size, (B, S), generator=g,
                          dtype=torch.int32),
            torch.randint(2, cfg.vocab_size, (B, steps), generator=g,
                          dtype=torch.int32))


def ms_params(model, qk):
    """Parameters from seed 0 on the card, wq and wk times ``qk``."""
    import torch
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    if qk != 1:
        scale_qk(attention_trees(params), qk)
    return params


def ms_grow(model, cache, first, n):
    """A prefill's caches grown by ``n`` decode slots from position
    ``first`` (the encoder-decoder's memory stays as it is)."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import encdec
    if model.cfg.is_encdec:
        return encdec.grow_cache(cache, first + n)
    return _grow_cache(cache, first, first + n)


def ms_unsharded(model, params, batch, feed, first, host=True):
    """The unsharded prefill over ``batch`` (on the card), its caches
    grown by the step count, then one decode step per column of ``feed``
    from position ``first``: {prefill logits, every step's logits (host),
    the prefill's caches by group (``cache_groups``): host copies, or
    their digests where ``host`` is False}."""
    import torch
    from repro_torch.training import steps as st
    from repro_torch.training.sharded_serve import cache_groups
    n = feed.shape[1]
    logits, cache = st.make_prefill_step(model)(params, batch)
    out = {"prefill": logits.float().cpu(), "cache": {
        j: {k: x.to("cpu", copy=True) if host else leaf_digest(x)
            for k, x in c.items()}
        for j, c in cache_groups(model.cfg, cache).items()}, "steps": []}
    cache = ms_grow(model, cache, first, n)
    serve = st.make_serve_step(model)
    for i in range(n):
        lg, cache = serve(params, cache, feed[:, i:i + 1].cuda(),
                          torch.tensor(first + i, device="cuda"))
        out["steps"].append(lg.float().cpu())
    del cache
    torch.cuda.synchronize()
    return out


def ms_sharded(mesh, model, params, batch, feed, first):
    """The sharded prefill over ``batch`` (host tensors) and ``feed``'s
    decode steps from position ``first`` over ``mesh`` on this rank
    (``make_prefill_step``/``make_serve_step`` with ``ac``): the flash
    launches of the prefill and of the whole run, its logits rows, each
    cache block's digest and spec by group and leaf (``cache_groups``),
    each step's logits rows and seconds, this rank's cache bytes and peak
    memory, and where its rows and blocks sit."""
    import torch
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.training import steps as st
    from repro_torch.training.sharded_serve import cache_groups, serve_steps
    n = feed.shape[1]
    ac = make_ac(mesh)
    steps = serve_steps(model, ac)
    local = steps.shard_params(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, blocks = st.make_prefill_step(model, ac=ac)(
        local, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    place = steps.layout(blocks)
    groups = cache_groups(model.cfg, blocks)
    out = {"flash_prefill": all_launches()["flash_attention_fwd"],
           "prefill": logits.float().cpu(), "pre_s": pre_s,
           "digests": {j: {k: leaf_digest(x) for k, x in c.items()}
                       for j, c in groups.items()},
           "specs": {j: {k: place[j].leaf_spec(k) for k in c}
                     for j, c in groups.items()},
           "coords": dict(steps.coords), "sizes": dict(steps.sizes)}
    whole = ms_grow(model, steps.whole_cache(blocks), first, n)
    del blocks
    blocks = steps.place_cache(whole)
    out["cache_bytes"] = tensor_bytes(blocks)
    out["whole_cache_bytes"] = tensor_bytes(whole)
    del whole
    serve = st.make_serve_step(model, ac=ac)
    out["steps"], out["step_s"] = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, blocks = serve(local, blocks, feed[:, i:i + 1].cuda(),
                           torch.tensor(first + i, device="cuda"))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["steps"].append(lg.float().cpu())
    out["flash"] = all_launches()["flash_attention_fwd"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del local, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ms_rank_one(rank, world, device):
    """Phase 20(a): an NCCL world of 1, full-width gemma2-2b: the
    unsharded steps, then the sharded ones over a model=1 mesh, in this
    process. Returns whether every logit and block is the same bits, and
    the sharded run's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(model=1, data=1, device_type="cuda",
                             backend="nccl")
    model = build_model(get_config("gemma2-2b"))
    prompt, feed = ms_inputs(model.cfg, MS_B, MS_S, MS_STEPS, 20)
    params = ms_params(model, 1)
    want = ms_unsharded(model, params, {"tokens": prompt.cuda()}, feed,
                        MS_S, host=False)
    got = ms_sharded(mesh, model, params, {"tokens": prompt}, feed, MS_S)
    del params
    same = torch.equal(got["prefill"], want["prefill"]) and all(
        torch.equal(a, b) for a, b in zip(got["steps"], want["steps"]))
    return {"same_logits": same, "same_cache": got["digests"] == want["cache"],
            "flash": got["flash_prefill"], "pre_s": got["pre_s"],
            "step_s": got["step_s"], "peak_gb": got["peak_gb"],
            "tokens": [int(x) for x in want["steps"][-1][:, 0].argmax(-1)]}


def ms_rank_two(rank, world, device, prompt, feed, config_path):
    """Phase 20's gloo world of 2 on one card: (b) full-width gemma2-2b
    cut to MS_LAYERS layers at model=2 (wq, wk times QK_SCALE); (d)
    ``serve.main --tiny --autotune 8`` over the world, then its record
    served with ``--serving-config``, each rank's output captured, and a
    mesh_model=2 candidate measured (``ms_mesh_candidate``)."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(get_config("gemma2-2b").replace(
        num_layers=MS_LAYERS))
    mesh = make_serving_mesh(model=2, data=1, device_type="cuda",
                             backend="gloo")
    t0 = time.perf_counter()
    res = {"b": ms_sharded(mesh, model, ms_params(model, QK_SCALE),
                           {"tokens": prompt}, feed, MS_S)}
    res["b_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["seq_tp"] = ms_seq_tp(mesh, model, prompt)
    res["seq_tp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, argv in (("tune", MS_AUTOTUNE + ["--autotune-out",
                                              config_path]),
                      ("load", ["--arch", "gemma2-2b", "--tiny",
                                "--requests", "4", "--prompt-len", "24",
                                "--gen", "8", "--max-batch", "4",
                                "--serving-config", config_path])):
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            serve.main(argv)
        res[key] = (so.getvalue(), se.getvalue())
        torch.distributed.barrier()
    res["mesh2"] = ms_mesh_candidate()
    res["d_s"] = time.perf_counter() - t0
    return res


def ms_seq_tp(mesh, model, prompt):
    """Phase 20(b)'s seq_tp runs on ``model`` (gemma2-2b cut to MS_LAYERS
    layers) over ``mesh`` (model=2): the prefill over ``prompt`` through
    ``make_ac(mesh, "seq_tp")`` and through dp from the same shards (its
    logits, each cache block's digest, flash launches, peak), then one
    train step of each from seed 0 (wq, wk times QK_SCALE) at B MS_B x S
    MS_S (``mt_sharded_steps``: metrics, master samples, flash launches)
    and this rank's peak over it."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.training import steps as st
    from repro_torch.training.sharded import ShardedTrainer
    from repro_torch.training.sharded_serve import cache_groups, serve_steps
    out = {}
    params = ms_params(model, QK_SCALE)
    for mode in ("dp", "seq_tp"):
        ac = make_ac(mesh, mode)
        local = serve_steps(model, ac).shard_params(params)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        logits, blocks = st.make_prefill_step(model, ac=ac)(
            local, {"tokens": prompt.cuda()})
        torch.cuda.synchronize()
        out[("prefill", mode)] = {
            "logits": logits.float().cpu(),
            "digests": {j: {k: leaf_digest(x) for k, x in c.items()}
                        for j, c in cache_groups(model.cfg, blocks).items()},
            "flash": all_launches()["flash_attention_fwd"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del local, blocks, logits
    del params
    shape = ShapeConfig("train", MS_S, MS_B, "train")
    for mode in ("dp", "seq_tp"):
        tr = ShardedTrainer(model, mt_tcfg(""), make_ac(mesh, mode))
        state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
        scale_qk_state(state, QK_SCALE)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, steps = mt_sharded_steps(tr, state, model, shape, 1,
                                        sample=True)
        out[("train", mode)] = {
            "steps": steps, "peak_gb": torch.cuda.max_memory_allocated()
            / 1e9}
        del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ms_mesh_candidate():
    """Phase 20(d)'s mesh_model=2 candidate, measured as the search
    measures its top candidates (``measure_candidate``: the engine on a
    sub-mesh of the first 2 ranks, rank 0's numbers every rank's), on
    MS_AUTOTUNE's tiny model and trace; the search's own top 3 need not
    hold one."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.core.hardware_model import HARDWARES
    from repro_torch.models.api import build_model
    from repro_torch.serving.autotune import (ConfigSpace, ScoredCandidate,
                                              measure_candidate)
    from repro_torch.serving.engine import Request
    cfg = tiny_config("gemma2-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    space = ConfigSpace(cfg, HARDWARES["h100-sxm"], max_model_len=32,
                        max_devices=2, max_batch_cap=4,
                        param_bytes=model.param_bytes())
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, 24)
                    .astype(np.int32), max_new=8) for i in range(4)]
    config = dataclasses.replace(space.default(), mesh_model=2)
    got = measure_candidate(model, params, space, ScoredCandidate(
        config=config, score=1.0, admissible=True), reqs)
    return dataclasses.asdict(got)


def ms_rank_four(rank, world, device, prompt, feed):
    """Phase 20(c): tiny gemma2-2b (wq, wk times 1/8, as the CPU tests)
    in a gloo world of 4 on one card, at data=2 x model=2 and at model=4
    (query heads a rank over a kv head sliced per rank, ``kv_span``)."""
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(tiny_config("gemma2-2b"))
    out = {}
    for data, tp in ((2, 2), (1, 4)):
        mesh = make_serving_mesh(model=tp, data=data, device_type="cuda",
                                 backend="gloo")
        out[(data, tp)] = ms_sharded(mesh, model, ms_params(model, 0.125),
                                     {"tokens": prompt}, feed, MS_TINY_S)
    return out


def ms_hold(label, got, want, rows=None):
    """A sharded run's logits against the unsharded run's (``rows``: the
    rank's rows of them): the prefill bit for bit where ``exact``, each
    decode step within LOGIT_RTOL of max |logit| and the same greedy
    token wherever the unsharded top-2 margin exceeds that. Returns the
    worst |diff| over the steps, relative to max |logit|."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
        b = b if rows is None else b[rows]
        a, b = a[:, 0], b[:, 0]
        if not torch.isfinite(a).all():
            fail(f"{label}: step {i}: non-finite logits")
        scale = float(b.abs().max())
        d = float((a - b).abs().max())
        top2 = torch.topk(b, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_RTOL * scale
        if d > LOGIT_RTOL * scale or not bool(
                ((a.argmax(-1) == b.argmax(-1)) | ~clear).all()):
            fail(f"{label}: decode step {i}: logits differ by {d:.4g} "
                 f"(tolerance {LOGIT_RTOL * scale:.4g}), greedy "
                 f"{a.argmax(-1).tolist()} vs {b.argmax(-1).tolist()}")
        worst = max(worst, d / scale)
    return worst


def ms_blocks_equal(got, cache, rows=None):
    """Whether every block of a sharded prefill is the same bits as its
    slice of the unsharded prefill's caches (host tensors by group)."""
    from repro_torch.distributed.sharding import local_block
    for j, c in cache.items():
        for n, x in c.items():
            spec = list(got["specs"][j][n])
            if rows is not None:
                spec[1] = None           # the unsharded run was the row's
            block = local_block(x, tuple(spec), got["sizes"], got["coords"])
            if leaf_digest(block.cuda()) != got["digests"][j][n]:
                return False
    return True


def phase_mesh_serve():
    """Phase 20: the sharded prefill and serve steps on the card
    (training/sharded_serve.py). (a) an NCCL world of 1: full-width
    gemma2-2b, the sharded prefill over B 2 x 4096 (26 flash launches) and
    MS_STEPS decode steps, bit-identical to the unsharded steps run first
    in the same process. (b) a gloo world of 2 on this card, model=2: full
    width cut to MS_LAYERS layers, the caches split on their sequence (each
    ring a block of 2048 slots a rank): the prefill's logits and each
    rank's blocks bit-identical to the unsharded run's where a product
    over a column slice equals the slice of the whole product
    (``cublas_slices``), else the logits under LOGIT_RTOL; MS_STEPS
    decode steps across the ring's wrap over caches grown to 4100 slots,
    teacher-forced, under LOGIT_RTOL with greedy tokens equal wherever the
    margin allows. (c) tiny gemma2-2b in a gloo world of 4 at data=2 x
    model=2 and model=4, under the same rules (data=2: against the
    unsharded run on each rank's rows). (d) ``serve.main --tiny
    --autotune 8`` over the world of 2: both ranks' winner the same, the
    record served by ``--serving-config``, a mesh_model=2 candidate
    measured with the same numbers on both ranks. The unsharded runs come first, here; then (a)
    and (c) run beside (b, d)'s world, whose host-staged gloo copies leave
    the card mostly idle. Returns the flash launches of the sharded
    prefills, summed over ranks."""
    import tempfile
    import types
    import torch
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.launch.mesh import WorldFailed, spawn
    from repro_torch.models.api import build_model

    card = card_line()
    flash = 0
    # the unsharded runs (b) and (c) are held to, here, first
    cut = build_model(get_config("gemma2-2b").replace(num_layers=MS_LAYERS))
    prompt, feed = ms_inputs(cut.cfg, MS_B, MS_S, MS_STEPS, 21)
    params = ms_params(cut, QK_SCALE)
    want_b = ms_unsharded(cut, params, {"tokens": prompt.cuda()}, feed,
                          MS_S)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    slices = cublas_slices(get_config("gemma2-2b"), [{"policy":
        types.SimpleNamespace(max_batch=MS_B, prefill_chunk=MS_B * MS_S)}])
    exact = all(v == 0.0 for v in slices.values())
    tiny = build_model(tiny_config("gemma2-2b"))
    t_prompt, t_feed = ms_inputs(tiny.cfg, 2, MS_TINY_S, MS_TINY_STEPS, 22)
    t_params = ms_params(tiny, 0.125)
    want_c = {None: ms_unsharded(tiny, t_params,
                                 {"tokens": t_prompt.cuda()}, t_feed,
                                 MS_TINY_S)}
    for r in range(2):                    # data=2: a rank's row alone
        want_c[r] = ms_unsharded(tiny, t_params,
                                 {"tokens": t_prompt[r:r + 1].cuda()},
                                 t_feed[r:r + 1], MS_TINY_S)
    del t_params
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 20's unsharded runs")

    def world(label, fn, n, backend, args=()):
        t0 = time.perf_counter()
        try:
            out = spawn(fn, n, backend=backend, device="cuda:0",
                        timeout_s=MS_WORLD_S, args=args)
        except WorldFailed as e:
            fail(f"mesh-serve[{label}]: the {backend} world of {n} "
                 f"failed:\n{e}")
        return out, time.perf_counter() - t0

    # (a) and then (c) run beside (b, d)'s world, whose host-staged gloo
    # copies leave the card idle: every world holds its own checks
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        side = pool.submit(lambda: (
            world("a", ms_rank_one, 1, "nccl"),
            world("c", ms_rank_four, 4, "gloo", (t_prompt, t_feed))))
        two, two_s = world("b, d", ms_rank_two, 2, "gloo",
                           (prompt, feed, str(Path(tmp) / "serving.json")))
        ((one,), one_s), (four, four_s) = side.result()
    mark("phase 20's worlds")
    # (a)
    if not (one["same_logits"] and one["same_cache"]):
        fail(f"mesh-serve[a]: the sharded steps on a world of 1 are not the "
             f"unsharded steps bit for bit (logits {one['same_logits']}, "
             f"caches {one['same_cache']})")
    if one["flash"] != 26:
        fail(f"mesh-serve[a]: {one['flash']} flash launches in the prefill")
    flash += one["flash"]
    print(f"mesh-serve[a nccl world of 1, gemma2-2b B={MS_B} S={MS_S}]: "
          f"prefill ({one['flash']} flash launches) and {MS_STEPS} decode "
          f"steps bit-identical to the unsharded steps, every cache leaf "
          f"too; prefill {one['pre_s']:.3f} s, a step "
          f"{sorted(one['step_s'])[MS_STEPS // 2] * 1e3:.1f} ms (median; "
          f"its host shared with (b)'s and (c)'s worlds), peak "
          f"{one['peak_gb']:.2f} GB; {one_s:.1f} s with spawn ({card})",
          flush=True)
    # (b)
    label = "mesh-serve[b gloo model=2]"
    worst = 0.0
    for i, r in enumerate(two):
        b = r["b"]
        same = torch.equal(b["prefill"], want_b["prefill"]) and \
            ms_blocks_equal(b, want_b["cache"])
        if exact and not same:
            fail(f"{label}: rank {i}'s prefill logits or cache blocks differ "
                 f"from the unsharded run's, though every column slice's "
                 f"product equals the slice of the whole")
        if not same:
            d = float((b["prefill"] - want_b["prefill"]).abs().max())
            if d > LOGIT_RTOL * float(want_b["prefill"].abs().max()):
                fail(f"{label}: rank {i}'s prefill logits differ by {d:.4g}")
        worst = max(worst, ms_hold(f"{label} rank {i}", b, want_b))
        if b["flash_prefill"] != MS_LAYERS:
            fail(f"{label}: rank {i}: {b['flash_prefill']} flash launches "
                 f"in the prefill")
        if 2 * b["cache_bytes"] != b["whole_cache_bytes"]:
            fail(f"{label}: rank {i} holds {b['cache_bytes']} cache bytes of "
                 f"{b['whole_cache_bytes']}")
        flash += b["flash"]
        print(f"{label}: rank {i}: prefill logits and blocks "
              f"{'bit-identical' if same else 'not bit-identical'} to the "
              f"unsharded run's (column slices exact: {exact}); cache "
              f"{b['cache_bytes'] / 1e9:.4f} GB of the whole's "
              f"{b['whole_cache_bytes'] / 1e9:.4f} (blocks {b['specs']}); "
              f"peak {b['peak_gb']:.2f} GB; prefill {b['pre_s']:.2f} s, a "
              f"decode step {sorted(b['step_s'])[MS_STEPS // 2]:.2f} s "
              f"(median; host-staged gloo gathers on one card, not a "
              f"speed) ({card})", flush=True)
    print(f"{label}: gemma2-2b {MS_LAYERS} of 26 layers, B={MS_B} "
          f"S={MS_S}, wq, wk x {QK_SCALE}: {MS_STEPS} decode steps over "
          f"{MS_S + MS_STEPS} slots, teacher-forced, max |diff| "
          f"{worst:.3g} of max |logit| (tolerance {LOGIT_RTOL}); greedy "
          f"tokens equal where the margin allows; the world {two_s:.1f} s "
          f"with (d) ({two[0]['b_s']:.1f} s for (b))", flush=True)
    # (b) under make_ac(mesh, "seq_tp"), beside dp in the same world
    label = "mesh-serve[b gloo model=2 seq_tp]"
    for i, r in enumerate(two):
        pd, ps = (r["seq_tp"][("prefill", m)] for m in ("dp", "seq_tp"))
        if not (torch.equal(pd["logits"], ps["logits"])
                and pd["digests"] == ps["digests"]):
            fail(f"{label}: rank {i}'s seq_tp prefill logits or cache "
                 f"blocks differ from the dp prefill's")
        for run in (pd, ps):
            if run["flash"] != MS_LAYERS:
                fail(f"{label}: rank {i}: {run['flash']} flash launches in "
                     f"a prefill")
            flash += run["flash"]
        for m in ("dp", "seq_tp"):
            for s in r["seq_tp"][("train", m)]["steps"]:
                if s["flash"] != 2 * MS_LAYERS:
                    fail(f"{label}: rank {i}: {s['flash']} flash launches "
                         f"in a {m} train step")
                flash += s["flash"]
    got, want = ([(s["met"], merge_samples(
        [r["seq_tp"][("train", m)]["steps"][k]["masters"] for r in two]))
        for k, s in enumerate(two[0]["seq_tp"][("train", m)]["steps"])]
        for m in ("seq_tp", "dp"))
    line = hold_steps(f"{label} train", got, want,
                      [m["lr"] for m, _ in want])
    peaks = "; ".join(
        f"rank {i}: prefill {r['seq_tp'][('prefill', 'seq_tp')]['peak_gb']:.3f}"
        f" GB (dp {r['seq_tp'][('prefill', 'dp')]['peak_gb']:.3f}), train "
        f"step {r['seq_tp'][('train', 'seq_tp')]['peak_gb']:.3f} GB (dp "
        f"{r['seq_tp'][('train', 'dp')]['peak_gb']:.3f})"
        for i, r in enumerate(two))
    print(f"{label}: the prefill over B={MS_B} x {MS_S} bit-identical to "
          f"the dp prefill on both ranks (logits and every cache block); "
          f"one train step against dp's from the same state under phase "
          f"18's rules: {line}; peaks {peaks} (the remat checkpoint of the "
          f"one group saves {MS_B * MS_S * 2304 * 2 / 2 / 1e6:.1f} MB less "
          f"a rank); {two[0]['seq_tp_s']:.1f} s in all ({card})",
          flush=True)
    # (c)
    for (data, tp) in ((2, 2), (1, 4)):
        label = f"mesh-serve[c gloo data={data} x model={tp}]"
        worst = 0.0
        for i, r in enumerate(four):
            c = r[(data, tp)]
            row = c["coords"]["data"] if c["sizes"]["data"] > 1 else None
            want = want_c[row]
            same = torch.equal(c["prefill"], want["prefill"]) and \
                ms_blocks_equal(c, want["cache"], rows=row)
            if not same:
                fail(f"{label}: rank {i}'s prefill logits or blocks differ "
                     f"from the unsharded run's")
            worst = max(worst, ms_hold(f"{label} rank {i}", c, want))
            flash += c["flash"]
        print(f"{label}: tiny gemma2-2b B=2 S={MS_TINY_S} (flash at hd 32, "
              f"{four[0][(data, tp)]['flash']} launches a rank), prefill "
              f"logits and blocks bit-identical on every rank (data=2: the "
              f"unsharded run on the rank's row); {MS_TINY_STEPS} steps "
              f"across the ring's wrap within {worst:.3g} of max |logit|; "
              f"blocks {four[0][(data, tp)]['specs']}", flush=True)
    print(f"mesh-serve[c]: the world of 4 in {four_s:.1f} s", flush=True)
    # (d)
    out0, err0 = two[0]["tune"]
    _, err1 = two[1]["tune"]
    winners = [x.split("winner ", 1)[1] for x in
               (out0 + err1).splitlines() if "]: winner " in x]
    measured = [x for x in out0.splitlines() if "]: measured " in x]
    if len(winners) != 2 or winners[0] != winners[1] or not measured:
        fail(f"mesh-serve[d]: the ranks' winners differ: {winners}\n"
             f"{out0[-2000:]}\n{err0[-2000:]}\n{err1[-2000:]}")
    mesh2 = [r["mesh2"] for r in two]
    if mesh2[0] != mesh2[1] or mesh2[0]["scored"]["config"][
            "mesh_model"] != 2 or not mesh2[0]["decode_tok_s"] > 0:
        fail(f"mesh-serve[d]: the mesh_model=2 candidate's measurement: "
             f"{mesh2}")
    loaded = two[0]["load"][0]
    if "serving-config[h100-sxm]" not in loaded or "served 4 requests" \
            not in loaded:
        fail(f"mesh-serve[d]: the record did not serve:\n{loaded[-2000:]}")
    print(f"mesh-serve[d]: serve.main {' '.join(MS_AUTOTUNE)} over a gloo "
          f"world of 2: {measured[0].split(': ', 1)[1]}; both ranks' winner "
          f"{winners[0]}; a mesh_model=2 candidate measured alike on both "
          f"ranks: {mesh2[0]['decode_tok_s']:.1f} tok/s, "
          f"{mesh2[0]['decode_ticks']} decode ticks; --serving-config "
          f"served the winner: "
          f"{[x for x in loaded.splitlines() if 'served' in x][0]}. gloo on "
          f"one card times host copies, so these tok/s cannot rank the "
          f"mesh candidates by speed ({card}); (d) in "
          f"{two[0]['d_s']:.1f} s", flush=True)
    return flash


# --------------- phase 21: the ssm, hybrid, encdec and vlm families split --
# (a) an NCCL world of 1 at full width and depth; (b) a gloo world of 2 on
# this card at data=2 and at model=2, every width whole and the depth cut
# to MF_LAYERS (zamba2's 6: one hybrid group), as phases 17, 18 and 20 cut
# theirs. Serving on phases 13, 15 and 16's shapes at B = MF_B (mamba2 and
# zamba2: 4096 tokens; whisper: 16384 frames and 2048 decoder tokens;
# llava: 2048 patch rows and 6144 tokens), MF_DECODE teacher-forced steps
# over caches grown by as many slots (lengths model=2 divides: whisper's
# 16384 frames split 8192 a rank, where the cross attention still reaches
# flash); training B 2 x S 4096 (whisper: 4096 frames, 512 decoder tokens)
# for MF_STEPS steps. llava is served only: 7.26B parameters x 14 bytes of
# train state do not fit one card
MF_ARCHS = ("mamba2-370m", "zamba2-1.2b", WHISPER, LLAVA)
MF_TRAIN = MF_ARCHS[:3]
MF_B, MF_DECODE, MF_STEPS = 2, 2, 2
MF_LAYERS = {"mamba2-370m": 6, "zamba2-1.2b": 6, WHISPER: 4, LLAVA: 4}
MF_MESHES = ((2, 1), (1, 2))         # (b)'s (data, model)
MF_WORLD_S = 600.0


def mf_config(arch, cut):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=MF_LAYERS[arch]) if cut else cfg


def mf_inputs(cfg, seed):
    """A family's serving batch (host tensors at MF_B rows), the tokens
    fed at each decode step, and the first decode position."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def toks(S):
        return torch.randint(2, cfg.vocab_size, (MF_B, S), generator=g,
                             dtype=torch.int32)

    def embeds(S):
        return torch.randn((MF_B, S, cfg.d_model), generator=g).bfloat16()
    if cfg.is_encdec:
        batch = {"frames": embeds(W_FRAMES), "tokens": toks(W_PROMPT)}
    elif cfg.frontend == "vision_stub":
        batch = {"patches": embeds(L_PATCHES), "tokens": toks(L_TOKENS)}
    else:
        batch = {"tokens": toks(SSM_S)}
    first = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                        if "patches" in batch else 0)
    return batch, toks(MF_DECODE), first


def mf_rows(batch, rows):
    return {k: v[rows].cuda() for k, v in batch.items()}


def mf_train_shape():
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("train", W_TRAIN_S, W_TRAIN_B, "train")


def mf_train_unsharded(model, microbatches):
    """The one-device port from seed 0 (wq, wk times QK_SCALE), the batch
    cut into ``microbatches``: each step's (loss, grad norm)."""
    import dataclasses
    import torch
    from repro_torch.data import pipeline as dp
    from repro_torch.training import steps as steps_lib
    tcfg = dataclasses.replace(mt_tcfg(""), microbatches=microbatches)
    state = steps_lib.init_train_state(
        model, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    scale_qk_state(state, QK_SCALE)
    step = steps_lib.make_train_step(model, tcfg)
    shape = mf_train_shape()
    out = []
    for k in range(MF_STEPS):
        state, met = step(state, dp.batch_for_model(model, shape, None, k,
                                                    "cuda", full=True))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mf_train_sharded(mesh, model):
    """MF_STEPS sharded steps over ``mesh`` from seed 0 (wq, wk times
    QK_SCALE): each step's (loss, grad norm), seconds (rank 0's clock),
    flash launches on this rank; the state's bytes at rest and the peak."""
    import torch
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.training.sharded import ShardedTrainer
    torch.cuda.reset_peak_memory_stats()
    tr = ShardedTrainer(model, mt_tcfg(""), make_ac(mesh))
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    scale_qk_state(state, QK_SCALE)
    shape = mf_train_shape()
    out = {"steps": [], "s": [], "flash": 0,
           "rest_gb": tensor_bytes(state) / 1e9}
    for k in range(MF_STEPS):
        batch = dp.batch_for_model(model, shape, None, k, "cuda", full=True)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        state, met = tr.step(state, batch)
        out["steps"].append((float(met["loss"]), float(met["grad_norm"])))
        out["s"].append(tr.first_rank_float(time.perf_counter() - t0))
        out["flash"] += all_launches()["flash_attention_fwd"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mf_rank_one(rank, world, device):
    """Phase 21(a): an NCCL world of 1, every family at full width and
    depth: the sharded prefill and steps against the unsharded ones, then
    ``train(mesh=)`` against ``train()``, in this process. Returns per
    arch whether logits, caches, losses, grad norms and every leaf are the
    same bits, and the sharded runs' numbers."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(model=1, data=1, device_type="cuda",
                             backend="nccl")
    out = {}
    for i, arch in enumerate(MF_ARCHS):
        model = build_model(mf_config(arch, False))
        batch, feed, first = mf_inputs(model.cfg, 210 + i)
        params = ms_params(model, 1)
        want = ms_unsharded(model, params, {k: v.cuda() for k, v in
                                            batch.items()}, feed, first,
                            host=False)
        got = ms_sharded(mesh, model, params, batch, feed, first)
        del params
        same = torch.equal(got["prefill"], want["prefill"]) and all(
            torch.equal(a, b) for a, b in zip(got["steps"], want["steps"]))
        out[arch] = {"same_logits": same,
                     "same_cache": got["digests"] == want["cache"],
                     **{k: got[k] for k in ("flash", "flash_prefill",
                                            "pre_s", "step_s", "peak_gb")}}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MF_TRAIN:
        model = build_model(mf_config(arch, False))
        shape = mf_train_shape()
        runs = []
        for on_mesh in (True, False):
            with tempfile.TemporaryDirectory() as tmp:
                torch.cuda.reset_peak_memory_stats()
                reset_all_launches()
                r = train(model, shape, mt_tcfg(tmp), num_steps=MF_STEPS,
                          log=lambda r: None, **(
                              {"mesh": mesh} if on_mesh else
                              {"device": "cuda"}))
            runs.append({"hist": [(x["loss"], x["grad_norm"])
                                  for x in r["history"]],
                         "dt": [x["dt_s"] for x in r["history"]],
                         "digests": [leaf_digest(x)
                                     for x in tree_leaves(r["state"])],
                         "flash": all_launches()["flash_attention_fwd"],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            del r
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs
        out[(arch, "train")] = {"same": a["hist"] == b["hist"]
                                and a["digests"] == b["digests"],
                                **{k: a[k] for k in ("hist", "dt", "flash",
                                                     "peak_gb")},
                                "dt_unsharded": b["dt"]}
    return out


def mf_rank_two(rank, world, device, inputs):
    """Phase 21(b)'s rank: at each of MF_MESHES, every family (cut to
    MF_LAYERS, wq, wk times QK_SCALE) served from ``inputs[arch]``, and
    the three trained."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for data, tp in MF_MESHES:
        mesh = make_serving_mesh(model=tp, data=data, device_type="cuda",
                                 backend="gloo")
        for arch in MF_ARCHS:
            model = build_model(mf_config(arch, True))
            batch, feed, first = inputs[arch]
            t0 = time.perf_counter()
            out[(data, tp, arch)] = ms_sharded(
                mesh, model, ms_params(model, QK_SCALE), batch, feed, first)
            out[(data, tp, arch)]["s"] = time.perf_counter() - t0
        for arch in MF_TRAIN:
            t0 = time.perf_counter()
            out[(data, tp, arch, "train")] = mf_train_sharded(
                mesh, build_model(mf_config(arch, True)))
            out[(data, tp, arch, "train")]["wall"] = time.perf_counter() - t0
    return out


def mf_references(inputs):
    """Phase 21(b)'s unsharded runs on this process's card: each family's
    prefill and steps on the whole batch (model=2) and on each row alone
    (data=2), whether its column-slice products are exact
    (``cublas_slices``), and the trained families' steps in 1 and 2
    microbatches. Returns (serving runs, training runs, exact)."""
    import types
    import torch
    from repro_torch.models.api import build_model
    want_s, want_t, exact = {}, {}, {}
    for arch in MF_ARCHS:
        model = build_model(mf_config(arch, True))
        batch, feed, first = inputs[arch]
        params = ms_params(model, QK_SCALE)
        want_s[arch] = {None: ms_unsharded(model, params, mf_rows(
            batch, slice(None)), feed, first)}
        for r in range(MF_B):            # data=2: a rank's row alone
            want_s[arch][r] = ms_unsharded(
                model, params, mf_rows(batch, slice(r, r + 1)),
                feed[r:r + 1], first)
        if arch == "zamba2-1.2b":        # the model's own sensitivity
            with perturbed_attend():
                want_s[arch]["ulp"] = logit_gap(ms_unsharded(
                    model, params, mf_rows(batch, slice(None)), feed,
                    first), want_s[arch][None])
        del params
        cfg = model.cfg
        rows = [W_FRAMES, W_PROMPT] if cfg.is_encdec else [first]
        exact[arch] = not cfg.num_heads or all(v == 0.0 for v in
                                               cublas_slices(cfg, [
            {"policy": types.SimpleNamespace(max_batch=MF_B,
                                             prefill_chunk=MF_B * n)}
            for n in rows]).values())
        if arch in MF_TRAIN:
            want_t[arch] = {m: mf_train_unsharded(model, m) for m in (1, 2)}
        gc.collect()
        torch.cuda.empty_cache()
    return want_s, want_t, exact


# (c), ROADMAP item 11i: tiny gemma2-2b (wq, wk times 1/8) at data=3 x
# model=2 (a gloo world of 6 on this card) with B = 1, so that the batch
# takes no axis: its global layer's cache of CI_S slots (a length 2 does
# not divide and 3 does) splits on its slots over data and its kv heads
# over model, (None, None, 'data', 'model'); CI_STEPS decode steps over
# the caches grown to CI_T slots (split alike), beside (b)'s world
CI_S, CI_T, CI_STEPS = 9, 15, 4
# and then CI_TRAIN_STEPS train steps of one row of MT_TINY_S tokens
# (flash at hd 32): 3 divides neither the row nor its sequence, so data
# holds the row whole (ActivationLayout.replicated_axes)
CI_TRAIN_STEPS = 2


def ci_rank_six(rank, world, device, prompt, feed):
    """Phase 21(c)'s rank: the sharded prefill over ``prompt`` (1, CI_S)
    and ``feed``'s decode steps over the caches grown to CI_T slots: the
    logits (host), each cache block's digest and spec, where the rank
    sits."""
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models.api import build_model
    from repro_torch.training import steps as st
    from repro_torch.training.sharded_serve import cache_groups, serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(model=2, data=3, device_type="cuda",
                             backend="gloo")
    model = build_model(tiny_config("gemma2-2b"))
    ac = make_ac(mesh)
    steps = serve_steps(model, ac)
    local = steps.shard_params(ms_params(model, 0.125))
    logits, blocks = st.make_prefill_step(model, ac=ac)(
        local, {"tokens": prompt.cuda()})
    place = steps.layout(blocks)
    groups = cache_groups(model.cfg, blocks)
    out = {"prefill": logits.float().cpu(),
           "digests": {j: {k: leaf_digest(x) for k, x in c.items()}
                       for j, c in groups.items()},
           "specs": {j: {k: place[j].leaf_spec(k) for k in c}
                     for j, c in groups.items()},
           "coords": dict(steps.coords), "sizes": dict(steps.sizes),
           "steps": []}
    blocks = steps.place_cache(_grow_cache(steps.whole_cache(blocks), CI_S,
                                           CI_T))
    out["grown"] = {j: place.spec for j, place in steps.layout(
        blocks).items()}
    serve = st.make_serve_step(model, ac=ac)
    for i in range(feed.shape[1]):
        lg, blocks = serve(local, blocks, feed[:, i:i + 1].cuda(),
                           torch.tensor(CI_S + i, device="cuda"))
        out["steps"].append(lg.float().cpu())
    del local, blocks
    out["train"] = ci_train(model, ac)
    return out


def ci_train(model, ac):
    """Phase 21(c)'s training: CI_TRAIN_STEPS steps of one row of
    MT_TINY_S tokens from seed 0 (wq, wk times MT_TINY_QK) through the
    sharded trainer under ``ac``, past the layout check ``train(mesh=)``
    makes: the axes the step held whole, each step's metrics, flash
    launches and masters' samples on this rank (``mt_sharded_steps``)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.training.loop import _check_layout
    from repro_torch.training.sharded import ShardedTrainer
    tcfg = mt_tcfg("")
    shape = ShapeConfig("t", MT_TINY_S, 1, "train")
    tr = ShardedTrainer(model, tcfg, ac)
    _check_layout(model, tcfg, shape, ac, None)
    held = tr.rows(dp.batch_for_model(model, shape, None, 0, "cuda",
                                      full=True))[1].replicated
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    scale_qk_state(state, MT_TINY_QK)
    _, steps = mt_sharded_steps(tr, state, model, shape, CI_TRAIN_STEPS,
                                sample=True)
    return {"held": held, "steps": steps}


def logit_gap(got, want) -> float:
    """The largest |diff| of two runs' decode logits (``steps``), relative
    to the step's max |logit|."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got["steps"], want["steps"]))


def mf_world(label, fn, n, backend, args=()):
    """``spawn`` a world of phase 21 on this card: (its ranks' results,
    seconds); fatal if a rank fails or the deadline passes."""
    from repro_torch.launch.mesh import WorldFailed, spawn
    t0 = time.perf_counter()
    try:
        out = spawn(fn, n, backend=backend, device="cuda:0",
                    timeout_s=MF_WORLD_S, args=args)
    except WorldFailed as e:
        fail(f"mesh-families[{label}]: the {backend} world of {n} "
             f"failed:\n{e}")
    return out, time.perf_counter() - t0


class MeshFamilies:
    """Phase 21's worlds, each started ahead of the phase in a thread of
    its own and collected by ``phase_mesh_families``: (a), on the card's
    compute, beside phase 17's worlds, whose host-staged gloo leaves the
    card mostly idle (``start_one``); (b), host-staged itself, beside
    phases 19(a, b) and 20 (``start_two``)."""

    def __init__(self):
        from repro_torch.configs import tiny_config
        self.inputs = {arch: mf_inputs(mf_config(arch, True), 220 + i)
                       for i, arch in enumerate(MF_ARCHS)}
        self.ci_inputs = ms_inputs(tiny_config("gemma2-2b"), 1, CI_S,
                                   CI_STEPS, 231)
        self.pool = concurrent.futures.ThreadPoolExecutor(3)
        self.one = self.two = self.six = None

    def start_one(self):
        self.one = self.pool.submit(mf_world, "a", mf_rank_one, 1, "nccl")

    def start_two(self):
        self.t0 = time.perf_counter()
        self.two = self.pool.submit(mf_world, "b", mf_rank_two, 2, "gloo",
                                    (self.inputs,))

    def start_six(self):
        self.six = self.pool.submit(mf_world, "c", ci_rank_six, 6, "gloo",
                                    self.ci_inputs)


def phase_mesh_families(started=None):
    """Phase 21: the ssm, hybrid, encoder-decoder and vision-stub families
    split over a mesh (training/sharded.py, training/sharded_serve.py).
    (a) an NCCL world of 1 at full width and depth: the sharded prefill
    and MF_DECODE steps of all four families, and MF_STEPS steps of
    ``train(mesh=)`` of mamba2, zamba2 and whisper, bit-identical to the
    unsharded runs (whisper's full-depth grad norm is inf in both: its
    losses and leaves are compared). (b) a gloo world of 2 on this card
    at data=2 and at model=2, depth cut to MF_LAYERS: the prefill's logits
    and each rank's blocks bit-identical to the unsharded run's (data=2:
    its rows'; at model=2 where the column slices of the attention and
    FFN products are exact, ``cublas_slices``, else the logits under
    LOGIT_RTOL; mamba2 has none: exact), decode under LOGIT_RTOL
    (``ms_hold``), a rank's cache bytes half the whole's; training: losses
    within 2**-10 and grad norms within 2**-7 of the one-device run in as
    many microbatches as the mesh has data ranks (MT_*'s rules).
    ``started``: the worlds, started earlier (``MeshFamilies``; here, side
    by side, if None); the unsharded runs (b) is held to run here while
    they end. Returns the flash launches of the sharded runs, summed over
    ranks."""
    import torch

    from repro_torch.configs import ShapeConfig, tiny_config
    from repro_torch.models.api import build_model

    card = card_line()
    if started is None:
        started = MeshFamilies()
        started.start_two()
        started.start_one()
    started.start_six()
    with started.pool:
        want_s, want_t, exact = mf_references(started.inputs)
        tiny = build_model(tiny_config("gemma2-2b"))
        t_params = ms_params(tiny, 0.125)
        prompt, feed = started.ci_inputs
        want_ci = ms_unsharded(tiny, t_params, {"tokens": prompt.cuda()},
                               feed, CI_S)
        del t_params
        want_ci_train = mt_unsharded(
            tiny, ShapeConfig("t", MT_TINY_S, 1, "train"), CI_TRAIN_STEPS,
            MT_TINY_QK, "", sample=True)
        mark("phase 21's unsharded runs")
        two, two_s = started.two.result()
        (one,), one_s = started.one.result()
        six, six_s = started.six.result()
    mark("phase 21's worlds")
    flash = 0
    # (a)
    for arch in MF_ARCHS:
        r = one[arch]
        if not (r["same_logits"] and r["same_cache"]):
            fail(f"mesh-families[a {arch}]: the sharded steps on a world of "
                 f"1 are not the unsharded steps bit for bit (logits "
                 f"{r['same_logits']}, caches {r['same_cache']})")
        flash += r["flash"]
        print(f"mesh-families[a nccl world of 1, {arch} full width]: "
              f"prefill and {MF_DECODE} decode steps bit-identical to the "
              f"unsharded steps, every cache leaf too; {r['flash']} flash "
              f"launches ({r['flash_prefill']} in the prefill); prefill "
              f"{r['pre_s']:.3f} s, a step "
              f"{sorted(r['step_s'])[MF_DECODE // 2] * 1e3:.1f} ms (its "
              f"host shared with (b)'s world), peak {r['peak_gb']:.2f} GB "
              f"({card})", flush=True)
    for arch in MF_TRAIN:
        r = one[(arch, "train")]
        if not r["same"]:
            fail(f"mesh-families[a {arch} train]: train(mesh=) on a world "
                 f"of 1 is not train() bit for bit: {r['hist']}")
        flash += r["flash"]
        print(f"mesh-families[a {arch} train B={W_TRAIN_B} S={W_TRAIN_S}]: "
              f"{MF_STEPS} steps of train(mesh=) bit-identical to train() "
              f"(losses, grad norms and every leaf): "
              + ", ".join(f"loss {lo:.6f} grad norm {gn:.5g}"
                          for lo, gn in r["hist"])
              + f"; steps {', '.join(f'{x:.3f}' for x in r['dt'])} s on the "
              f"mesh vs {', '.join(f'{x:.3f}' for x in r['dt_unsharded'])} "
              f"s unsharded; peak {r['peak_gb']:.2f} GB; {r['flash']} flash "
              f"launches ({card})", flush=True)
    print(f"mesh-families[a]: the world of 1 in {one_s:.1f} s", flush=True)
    # (b) serving
    worsts = {}
    for data, tp in MF_MESHES:
        for arch in MF_ARCHS:
            label = f"mesh-families[b gloo data={data} x model={tp} {arch}]"
            worst, lines = 0.0, []
            for i, r in enumerate(two):
                b = r[(data, tp, arch)]
                row = b["coords"]["data"] if data > 1 else None
                want = want_s[arch][row]
                same = torch.equal(b["prefill"], want["prefill"]) and \
                    ms_blocks_equal(b, want["cache"], rows=row)
                if not same and (data > 1 or exact[arch]):
                    fail(f"{label}: rank {i}'s prefill logits or cache "
                         f"blocks differ from the unsharded run's")
                if not same:
                    d = float((b["prefill"] - want["prefill"]).abs().max())
                    if d > LOGIT_RTOL * float(want["prefill"].abs().max()):
                        fail(f"{label}: rank {i}'s prefill logits differ by "
                             f"{d:.4g}")
                worst = max(worst, ms_hold(f"{label} rank {i}", b, want))
                if 2 * b["cache_bytes"] != b["whole_cache_bytes"]:
                    fail(f"{label}: rank {i} holds {b['cache_bytes']} cache "
                         f"bytes of {b['whole_cache_bytes']}")
                flash += b["flash"]
                lines.append(
                    f"rank {i}: prefill "
                    f"{'bit-identical' if same else 'not bit-identical'}, "
                    f"cache {b['cache_bytes'] / 1e9:.4f} of "
                    f"{b['whole_cache_bytes'] / 1e9:.4f} GB, peak "
                    f"{b['peak_gb']:.2f} GB, prefill {b['pre_s']:.2f} s, a "
                    f"step {sorted(b['step_s'])[MF_DECODE // 2]:.2f} s, "
                    f"{b['flash']} flash launches ({b['flash_prefill']} in "
                    f"the prefill), {b['s']:.1f} s in all")
            worsts[(data, tp, arch)] = worst
            print(f"{label}: {MF_LAYERS[arch]} layers, decode within "
                  f"{worst:.3g} of max |logit| (tolerance {LOGIT_RTOL}); "
                  f"blocks {two[0][(data, tp, arch)]['specs']}; "
                  + "; ".join(lines) + f" (host-staged gloo, not a speed; "
                  f"{card})", flush=True)
    z = "zamba2-1.2b"
    print(f"mesh-families[b {z} control]: the one-device decode with a "
          f"bf16 ulp (2**-7) on a seeded tenth of its attention outputs "
          f"(perturbed_attend) moves its logits by {want_s[z]['ulp']:.3g} "
          f"of max |logit|; the model=2 decode (the combine of the ranks' "
          f"softmaxes) moved them by {worsts[(1, 2, z)]:.3g}", flush=True)
    # (b) training
    for data, tp in MF_MESHES:
        for arch in MF_TRAIN:
            label = f"mesh-families[b gloo data={data} x model={tp} " \
                f"{arch} train]"
            want = want_t[arch][data]
            for i, r in enumerate(two):
                t = r[(data, tp, arch, "train")]
                for k, ((lo, gn), (wl, wg)) in enumerate(zip(t["steps"],
                                                             want)):
                    if not (abs(lo - wl) <= MT_LOSS_RTOL * abs(wl) and
                            abs(gn - wg) <= MT_NORM_RTOL * abs(wg)):
                        fail(f"{label}: rank {i} step {k}: loss {lo} vs "
                             f"{wl}, grad norm {gn} vs {wg}")
                flash += t["flash"]
            t = two[0][(data, tp, arch, "train")]
            print(f"{label}: {MF_LAYERS[arch]} layers, B={W_TRAIN_B} "
                  f"S={W_TRAIN_S}, wq, wk x {QK_SCALE}, against the "
                  f"one-device run in {data} microbatch(es): "
                  + "; ".join(f"step {k}: loss {lo:.6f} vs {wl:.6f}, grad "
                              f"norm {gn:.5g} vs {wg:.5g}"
                              for k, ((lo, gn), (wl, wg)) in enumerate(
                                  zip(t["steps"], want)))
                  + "; ranks' state at rest "
                  + ", ".join(f"{r[(data, tp, arch, 'train')]['rest_gb']:.3f}"
                              for r in two)
                  + " GB, peaks "
                  + ", ".join(f"{r[(data, tp, arch, 'train')]['peak_gb']:.2f}"
                              for r in two)
                  + f" GB; steps {', '.join(f'{x:.2f}' for x in t['s'])} s "
                  f"(host-staged gloo, not a speed); {t['flash']} flash "
                  f"launches a rank; {t['wall']:.1f} s in all ({card})",
                  flush=True)
    print(f"mesh-families[b]: the world of 2 in {two_s:.1f} s", flush=True)
    # (c) a cache split over data (item 11i)
    label = "mesh-families[c gloo data=3 x model=2, tiny gemma2-2b B=1]"
    worst = 0.0
    for i, r in enumerate(six):
        if r["specs"]["sub1"]["k"] != (None, None, "data", "model", None) \
                or r["grown"]["sub1"] != r["specs"]["sub1"]["k"]:
            fail(f"{label}: rank {i}'s global cache is placed "
                 f"{r['specs']['sub1']} (grown: {r['grown']['sub1']}), not "
                 f"its slots over data and its kv heads over model")
        if not (torch.equal(r["prefill"], want_ci["prefill"])
                and ms_blocks_equal(r, want_ci["cache"])):
            fail(f"{label}: rank {i}'s prefill logits or cache blocks differ "
                 f"from the one-device prefill's")
        worst = max(worst, ms_hold(f"{label} rank {i}", r, want_ci))
    print(f"{label}: a prompt of {CI_S} tokens, the global layer's cache "
          f"{six[0]['specs']['sub1']['k']} (the ring "
          f"{six[0]['specs']['sub0']['k']}): the prefill's logits and every "
          f"rank's blocks bit-identical to the one-device cache's; "
          f"{CI_STEPS} decode steps over {CI_T} slots (only the rank whose "
          f"slots hold pos writes it; the softmaxes combined over data) "
          f"within {worst:.3g} of max |logit| of the one-device steps "
          f"(tolerance {LOGIT_RTOL}); the world of 6 in {six_s:.1f} s "
          f"({card})", flush=True)
    flash += ci_hold_train([r["train"] for r in six], want_ci_train,
                           tiny.cfg.num_layers, card)
    return flash


def ci_hold_train(ranks, want, layers, card):
    """Phase 21(c)'s training: the step held whole over data on every
    rank; the ranks' metrics the same bits at every step and the data
    ranks' sampled masters too (``merge_replicas``: a rank's blocks are
    its model rank's); the steps under phase 18's bf16 rules against the
    one-device run (the row is one device's on each data rank); each rank
    ``layers`` x 2 flash launches a step. Returns the flash launches,
    summed over ranks."""
    label = "mesh-families[c train, tiny gemma2-2b B=1 S=" \
        f"{MT_TINY_S} at data=3 x model=2, the row whole over data]"
    flash = 0
    for i, r in enumerate(ranks):
        if r["held"] != ("data",):
            fail(f"{label}: rank {i}'s step held {r['held']} whole, not data")
        if [s["met"] for s in r["steps"]] != \
                [s["met"] for s in ranks[0]["steps"]]:
            fail(f"{label}: rank {i}'s metrics differ from rank 0's")
        for s in r["steps"]:
            if s["flash"] != layers * 2:
                fail(f"{label}: rank {i}: {s['flash']} flash launches a step")
            flash += s["flash"]
    got, shared = [], 0
    for k, s in enumerate(ranks[0]["steps"]):
        masters, n = merge_replicas(f"{label} step {k}",
                                    [r["steps"][k]["masters"]
                                     for r in ranks])
        shared = max(shared, n)
        got.append((s["met"], masters))
    line = hold_steps(label, got, want, [m["lr"] for m, _ in want])
    same = "bit-identical" if got[0][0]["loss"] == want[0][0]["loss"] \
        else "not bit-identical"
    print(f"{label}: the 6 ranks' metrics the same bits at every step, the "
          f"sampled masters of every leaf the same bits on each data rank "
          f"({shared} of {len(got[0][1])} leaves held alike on several "
          f"ranks); the first loss {same} to the one-device run's; {CI_TRAIN_STEPS} steps against it: "
          f"{line}; flash launches a step a rank "
          f"{[s['flash'] for s in ranks[0]['steps']]} ({card})", flush=True)
    return flash


# ------ phase 22: moe over data ranks, stored weights under a model split --
# (a) an NCCL world of 1: granite-moe (full width, MQ_ONE_LAYERS of its 32
# layers: the whole model's 14 bytes of train state a parameter would not
# leave room beside phases 17-18's worlds on the card) through
# ``train(mesh=)`` against ``train()``; full-width gemma2-2b served on
# stored int8 and int4 weights through the sharded steps against the
# unsharded ones; and, on the card's compute while phase 17's worlds are
# host-staged, the one-device runs (b) is held to. (b) a gloo world of 2
# on this card, depth cut to MQ_LAYERS as phases 17-21 cut theirs:
# granite-moe at data=2 (moe_apply on one batch, the prefill, MQ_STEPS
# train steps on uniform random tokens, whose embedding rows are rarely
# repeated: a repeated row's bf16 gradient sum moves with the batch split,
# PERF.md section 6), gemma2-2b at model=2 on int8 and int4 codes and one
# HAQ fake-quant training step
MQ_LAYERS, MQ_ONE_LAYERS = 2, 8
MQ_B, MQ_S = 2, 4096            # granite-moe's batch: global C 2048 a layer
# moe_apply's rows share this offset, so that the random router favours
# some experts (2.7-8.8% of the routed pairs dropped at C over three
# router seeds on the CPU), as a trained model's chunks drop 0.46-5.36%
MQ_X_SHIFT = 0.25
MQ_TRAIN_B, MQ_TRAIN_S, MQ_STEPS = 2, 2048, 2
# (b)'s one row of MQ_TRAIN_S tokens at data=2: its sequence splits over
# data (DataSeqRows), every rank routing the whole rows
MQ_SEQ_B = 1
MQ_QS, MQ_DECODE = 1024, 2      # gemma2-2b's prompt and steps on codes
# the fake-quant policy of (b)'s HAQ step: (w_bits, a_bits) a site
MQ_HAQ = {"attn_q": (4, 16), "attn_k": (6, 16), "attn_v": (5, 16),
          "attn_o": (4, 16), "ffn_in": (3, 16), "ffn_gate": (6, 16),
          "ffn_out": (5, 8)}
MQ_WORLD_S = 600.0
QMM_NAMES = ("quant_matmul_w8a16", "quant_matmul_w4a16")


def mq_config(arch, layers):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers) if layers else cfg


def mq_moe_x(cfg):
    """granite-moe's moe_apply input (MQ_B, MQ_S, D), bf16 on the host."""
    import torch
    g = torch.Generator().manual_seed(221)
    return (torch.randn((MQ_B, MQ_S, cfg.d_model), generator=g)
            + MQ_X_SHIFT).bfloat16()


def mq_train_batch(cfg, k):
    """Train step ``k``'s global batch: uniform random tokens."""
    import torch
    g = torch.Generator().manual_seed(230 + k)
    t = torch.randint(2, cfg.vocab_size, (MQ_TRAIN_B, MQ_TRAIN_S),
                      generator=g, dtype=torch.int32)
    return {"tokens": t.cuda(), "labels": t.clone().cuda()}


def mq_seq_plans(model, mesh=None):
    """granite-moe's plan in every moe layer (models/moe.py::dispatch's
    idx, keep and dest, in the flat pairs' order, on the host) and the
    loss of one no-grad ``Model.loss`` over MQ_SEQ_B row of MQ_TRAIN_S
    uniform random tokens, from seed 0 (wq, wk times QK_SCALE): one
    device, or through the sharded trainer's hooks over ``mesh``, which
    split the sequence over data. Also the flash launches and seconds."""
    import torch
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.models import moe as moe_lib
    from repro_torch.training.sharded import ShardedTrainer
    g = torch.Generator().manual_seed(260)
    t = torch.randint(2, model.cfg.vocab_size, (MQ_SEQ_B, MQ_TRAIN_S),
                      generator=g, dtype=torch.int32).cuda()
    batch = {"tokens": t, "labels": t.clone()}
    params = ms_params(model, QK_SCALE)
    hooks = {}
    if mesh is not None:
        tr = ShardedTrainer(model, mt_tcfg(""), make_ac(mesh))
        params = tr.shard(params, tr.specs["params"])
        batch, ac = tr.rows(batch)
        hooks = dict(gather=tr.gather, ranks=tr.ranks, ac=ac,
                     dot=tr.dot)
    plans, dispatch = [], moe_lib.dispatch

    def record(idx, C, E, **kw):
        order, keep, dest = dispatch(idx, C, E, **kw)
        flat_keep, flat_dest = torch.empty_like(keep), torch.empty_like(dest)
        flat_keep[order], flat_dest[order] = keep, dest
        plans.append((idx.cpu(), flat_keep.cpu(), flat_dest.cpu()))
        return order, keep, dest
    moe_lib.dispatch = record
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            loss = float(model.loss(params, batch, **hooks))
    finally:
        moe_lib.dispatch = dispatch
    out = {"plans": plans, "loss": loss, "s": time.perf_counter() - t0,
           "flash": all_launches()["flash_attention_fwd"]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mq_moe_layer(params):
    """Layer 0's moe parameters (a view of the stacked tree)."""
    return {k: v[0] for k, v in params["blocks"]["sub0"]["moe"].items()}


def mq_plan(p, x, moe, ranks):
    """moe_apply on this rank's rows x and its plan: (y, aux, idx (T, k),
    whether each flat pair kept a slot, its global slot or -1) on the
    host."""
    import torch
    from repro_torch.models import moe as moe_lib
    y, aux = moe_lib.moe_apply(p, x, moe, ranks=ranks)
    T = x.shape[0] * x.shape[1]
    _, _, idx = moe_lib.route(p, x.reshape(T, -1), moe)
    C = moe_lib.capacity(T if ranks is None else ranks.total(T), moe)
    R = C if ranks is None else min(C, T)
    order, keep, dest = moe_lib.dispatch(idx, C, moe.num_experts,
                                         ranks=ranks, rows=R)
    e = idx.reshape(-1)
    counts = torch.bincount(e, minlength=moe.num_experts)
    below = torch.zeros_like(counts) if ranks is None \
        else ranks.prefix(counts)
    e_sorted = e[order]
    slot = torch.where(keep, below[e_sorted] + dest - e_sorted * R, -1)
    flat_keep, flat_slot = torch.empty_like(keep), torch.empty_like(slot)
    flat_keep[order], flat_slot[order] = keep, slot
    return {"y": y.float().cpu(), "aux": float(aux), "idx": idx.cpu(),
            "keep": flat_keep.cpu(), "slot": flat_slot.cpu()}


def mq_train(model, mesh=None, dot=None, steps=MQ_STEPS):
    """``steps`` steps from seed 0 (wq, wk times QK_SCALE) on
    ``mq_train_batch``: one device, or the sharded trainer over ``mesh``.
    Each step's (loss, grad norm), flash launches, seconds (rank 0's
    clock), peak."""
    import torch
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.training import steps as steps_lib
    from repro_torch.training.sharded import ShardedTrainer
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if mesh is None:
        tcfg = mt_tcfg("")
        state = steps_lib.init_train_state(model, tcfg, gen, "cuda")
        step, clock = steps_lib.make_train_step(model, tcfg, dot=dot), None
    else:
        tr = ShardedTrainer(model, mt_tcfg(""), make_ac(mesh), dot=dot)
        state = tr.init_state(gen)
        step, clock = tr.step, tr.first_rank_float
    scale_qk_state(state, QK_SCALE)
    out = {"steps": [], "s": [], "flash": 0}
    for k in range(steps):
        batch = mq_train_batch(model.cfg, k)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        out["steps"].append((float(met["loss"]), float(met["grad_norm"])))
        dt = time.perf_counter() - t0
        out["s"].append(clock(dt) if clock else dt)
        out["flash"] += all_launches()["flash_attention_fwd"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mq_stored(model, bits):
    """gemma2-2b's parameters from seed 0 (wq, wk times QK_SCALE) stored
    at ``bits`` on the card (serving/quant.py::quantize_params)."""
    import torch
    from repro_torch.serving.quant import quantize_params
    params = ms_params(model, QK_SCALE)
    q = quantize_params(params, default_bits=bits)
    del params
    torch.cuda.empty_cache()
    return q


def mq_serve(model, params, prompt, feed, mesh=None):
    """The prefill over ``prompt`` and ``feed``'s decode steps with
    ``dequant_dot``: unsharded, or the sharded steps over ``mesh`` on this
    rank's shards. Each step's logits (host), the W8A16/W4A16 and flash
    launches, the caches' digests and the seconds."""
    import torch
    from repro_torch.distributed.sharding import make_ac
    from repro_torch.serving.quant import dequant_dot
    from repro_torch.training import steps as st
    from repro_torch.training.sharded_serve import cache_groups, serve_steps
    S, n = prompt.shape[1], feed.shape[1]
    ac = None if mesh is None else make_ac(mesh)
    sv = None if ac is None else serve_steps(model, ac, dot=dequant_dot)
    local = params if sv is None else sv.shard_params(params)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, cache = st.make_prefill_step(model, ac=ac, dot=dequant_dot)(
        local, {"tokens": prompt.cuda()})
    out = {"prefill": logits.float().cpu(), "steps": [], "digests": {
        j: {k: leaf_digest(x) for k, x in c.items()}
        for j, c in cache_groups(model.cfg, cache).items()}}
    whole = cache if sv is None else sv.whole_cache(cache)
    cache = ms_grow(model, whole, S, n)
    if sv is not None:
        cache = sv.place_cache(cache)
    del whole
    serve = st.make_serve_step(model, ac=ac, dot=dequant_dot)
    for i in range(n):
        lg, cache = serve(local, cache, feed[:, i:i + 1].cuda(),
                          torch.tensor(S + i, device="cuda"))
        out["steps"].append(lg.float().cpu())
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    out["launches"] = {k: all_launches()[k] for k in QMM_NAMES
                       + ("flash_attention_fwd",)}
    del local, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mq_slice_checks(params, bits):
    """Every column-split site of layer 0 at model=2 (q, k, v, FFN in and
    gate): the kernel on each rank's slice of the stored codes against
    its plain version on the same slice, and against the whole call's
    columns, at the rows (b)'s prefill and decode give it, both within
    the kernel bound (``mismatch``); the K splits of both plans; the
    device ms of a slice's call and of the whole call (codes cycled past
    L2, ``cold_weight_sets``) beside the slice's bound. Returns per
    (site, M) the worst |err| over the ranks' slices against the plain
    version and against the whole call, the plans and the times."""
    import torch
    from repro_torch.kernels import quant_matmul as qm
    specs = qmm_specs()
    sub = params["blocks"]["sub0"]
    sites = {"attn_q": sub["attn"]["wq"], "attn_k": sub["attn"]["wk"],
             "attn_v": sub["attn"]["wv"], "ffn_in": sub["ffn"]["w_in"],
             "ffn_gate": sub["ffn"]["w_gate"]}
    g = torch.Generator(device="cuda").manual_seed(240)
    out = {}
    for site, w in sites.items():
        name = QMM_NAMES["q4" in w]
        fn, plain, _ = specs[name]
        codes = w["q4" if "q4" in w else "q"][0]
        codes = codes.reshape(codes.shape[0], -1)      # (K[/2], N) 2-D
        K = codes.shape[0] * (2 if "q4" in w else 1)
        N = codes.shape[1]
        scale = w["scale"][0]
        for M in (MQ_B * MQ_QS, MQ_B):
            x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
            whole = fn(x, codes, scale).float()
            worst = worst_plain = 0.0
            for r in range(2):
                cols = slice(r * N // 2, (r + 1) * N // 2)
                part = codes[:, cols].contiguous()
                got = fn(x, part, scale).float()
                errs = []
                for what, want in (("its plain version",
                                    plain(x, part, scale).float()),
                                   ("the whole call's columns",
                                    whole[:, cols])):
                    errs.append(float((got - want).abs().max()))
                    if mismatch(got, want).any():
                        fail(f"moe-quant[slices {site} {name} M={M}]: rank "
                             f"{r}'s slice is off {what} by {errs[-1]:.4g}")
                worst_plain = max(worst_plain, errs[0])
                worst = max(worst, errs[1])
            half = codes[:, :N // 2].contiguous()
            out[(site, M)] = {
                "err": worst, "plain_err": worst_plain, "N": N, "K": K,
                "name": name,
                "splits": (qm.qmm_splits(M, N // 2, K),
                           qm.qmm_splits(M, N, K)),
                "ms": device_ms(fn, cold_weight_sets((x, half, scale))),
                "whole_ms": device_ms(fn, cold_weight_sets((x, codes,
                                                            scale))),
                "bound_ms": qmm_bound_ms(name, M, K, N // 2)[0]}
    return out


def mq_rank_one(rank, world, device):
    """Phase 22(a): an NCCL world of 1, then the one-device runs (b) is
    held to, in this process."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.quantization import make_quant_dot
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.loop import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(model=1, data=1, device_type="cuda",
                             backend="nccl")
    out = {}
    # (a) granite-moe through train(mesh=) and train()
    moe = build_model(mq_config(MOE_ARCH, MQ_ONE_LAYERS))
    shape = ShapeConfig("train", MQ_TRAIN_S, MQ_TRAIN_B, "train")
    runs = []
    for on_mesh in (True, False):
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            r = train(moe, shape, mt_tcfg(tmp), num_steps=MQ_STEPS,
                      log=lambda r: None, **({"mesh": mesh} if on_mesh
                                             else {"device": "cuda"}))
        runs.append({"hist": [(x["loss"], x["grad_norm"])
                              for x in r["history"]],
                     "dt": [x["dt_s"] for x in r["history"]],
                     "digests": [leaf_digest(x)
                                 for x in tree_leaves(r["state"])],
                     "flash": all_launches()["flash_attention_fwd"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs
    out["moe_train"] = {"same": a["hist"] == b["hist"]
                        and a["digests"] == b["digests"],
                        **{k: a[k] for k in ("hist", "dt", "flash",
                                             "peak_gb")},
                        "dt_unsharded": b["dt"]}
    del moe
    # (a) full-width gemma2-2b on stored weights, sharded and unsharded
    gemma = build_model(mq_config("gemma2-2b", 0))
    prompt, feed = ms_inputs(gemma.cfg, MQ_B, MQ_QS, MQ_DECODE, 250)
    for bits in (8, 4):
        params = mq_stored(gemma, bits)
        want = mq_serve(gemma, params, prompt, feed)
        got = mq_serve(gemma, params, prompt, feed, mesh)
        del params
        out[("serve", bits)] = {
            "same": torch.equal(got["prefill"], want["prefill"]) and all(
                torch.equal(x, y) for x, y in zip(got["steps"],
                                                  want["steps"]))
            and got["digests"] == want["digests"],
            "launches": got["launches"], "s": got["s"]}
    del gemma
    gc.collect()
    torch.cuda.empty_cache()
    # (b)'s one-device runs
    moe = build_model(mq_config(MOE_ARCH, MQ_LAYERS))
    params = ms_params(moe, QK_SCALE)
    out["moe_apply"] = mq_plan(mq_moe_layer(params), mq_moe_x(
        moe.cfg).cuda(), moe.cfg.moe, None)
    prompt, _ = ms_inputs(moe.cfg, MQ_B, MQ_S, 0, 251)
    logits, _ = moe.prefill(params, {"tokens": prompt.cuda()})
    out["moe_prefill"] = logits.float().cpu()
    del params
    out["moe_train_ref"] = mq_train(moe)
    out["moe_seq"] = mq_seq_plans(moe)
    gemma = build_model(mq_config("gemma2-2b", MQ_LAYERS))
    prompt, feed = ms_inputs(gemma.cfg, MQ_B, MQ_QS, MQ_DECODE, 252)
    for bits in (8, 4):
        params = mq_stored(gemma, bits)
        out[("ref", bits)] = mq_serve(gemma, params, prompt, feed)
        with perturbed_attend():         # the model's own sensitivity
            out[("ulp", bits)] = logit_gap(mq_serve(gemma, params, prompt,
                                                    feed), out[("ref", bits)])
        del params
    out["haq_ref"] = mq_train(gemma, dot=make_quant_dot(MQ_HAQ), steps=1)
    return out


def mq_rank_two(rank, world, device):
    """Phase 22(b)'s rank: granite-moe at data=2, then gemma2-2b at
    model=2 on stored codes and one HAQ step."""
    import torch
    from repro_torch.core.quantization import make_quant_dot
    from repro_torch.distributed.sharding import batch_ranks, make_ac
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import steps as st
    from repro_torch.training.sharded_serve import serve_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    mesh = make_serving_mesh(model=1, data=2, device_type="cuda",
                             backend="gloo")
    ac = make_ac(mesh)
    groups = {a: mesh.get_group(a) for a in ("data", "model")}
    moe = build_model(mq_config(MOE_ARCH, MQ_LAYERS))
    params = ms_params(moe, QK_SCALE)
    x = ac(mq_moe_x(moe.cfg), "batch").cuda()
    out["moe_apply"] = mq_plan(mq_moe_layer(params), x, moe.cfg.moe,
                               batch_ranks(ac, MQ_B, groups))
    prompt, _ = ms_inputs(moe.cfg, MQ_B, MQ_S, 0, 251)
    local = serve_steps(moe, ac).shard_params(params)
    del params
    reset_all_launches()
    t0 = time.perf_counter()
    logits, _ = st.make_prefill_step(moe, ac=ac)(local,
                                                 {"tokens": prompt.cuda()})
    out["moe_prefill"] = {"logits": logits.float().cpu(),
                          "s": time.perf_counter() - t0,
                          "flash": all_launches()["flash_attention_fwd"]}
    del local, logits
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["moe_train"] = mq_train(moe, mesh)
    out["moe_train"]["wall"] = time.perf_counter() - t0
    out["moe_seq"] = mq_seq_plans(moe, mesh)
    mesh = make_serving_mesh(model=2, data=1, device_type="cuda",
                             backend="gloo")
    gemma = build_model(mq_config("gemma2-2b", MQ_LAYERS))
    prompt, feed = ms_inputs(gemma.cfg, MQ_B, MQ_QS, MQ_DECODE, 252)
    for bits in (8, 4):
        params = mq_stored(gemma, bits)
        out[("serve", bits)] = mq_serve(gemma, params, prompt, feed, mesh)
        del params
    t0 = time.perf_counter()
    out["haq"] = mq_train(gemma, mesh, dot=make_quant_dot(MQ_HAQ), steps=1)
    out["haq"]["wall"] = time.perf_counter() - t0
    return out


class MoeQuant:
    """Phase 22(a)'s world in a thread of its own, started ahead of the
    phase once phase 21's world of 1 has ended, beside phase 17's
    host-staged worlds, and waited for before phase 18's full-depth world
    of 1 (``wait``): the card's memory holds one such world at a time.
    (b) runs in ``phase_moe_quant``, after phase 21, when no other world
    holds the card."""

    def __init__(self):
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.one = None

    def start(self, after=None):
        """Start (a) once the future ``after`` (if any) is done."""
        def run():
            if after is not None:
                after.result()
            (one,), one_s = mf_world("moe-quant a", mq_rank_one, 1, "nccl")
            return one, one_s
        self.one = self.pool.submit(run)

    def wait(self):
        """(a)'s results, once it has ended (fatal if it failed)."""
        return self.one.result()


def mq_hold_train(label, got, want):
    """Each step's loss within MT_LOSS_RTOL and grad norm within
    MT_NORM_RTOL of ``want``'s."""
    for k, ((lo, gn), (wl, wg)) in enumerate(zip(got, want)):
        if not (abs(lo - wl) <= MT_LOSS_RTOL * abs(wl)
                and abs(gn - wg) <= MT_NORM_RTOL * abs(wg)):
            fail(f"{label}: step {k}: loss {lo} vs {wl}, grad norm {gn} "
                 f"vs {wg}")
    return "; ".join(f"step {k}: loss {lo:.6f} vs {wl:.6f}, grad norm "
                     f"{gn:.5g} vs {wg:.5g}"
                     for k, ((lo, gn), (wl, wg)) in enumerate(zip(got, want)))


def phase_moe_quant(started=None):
    """Phase 22: the moe family over data ranks (item 11e) and stored and
    fake-quantized weights under a model split (item 11g). ``started``:
    the worlds, started earlier (``MoeQuant``; here if None). Returns the
    launches of its sharded runs, summed over ranks: {flash, W8A16,
    W4A16}."""
    import torch
    from repro_torch.models import moe as moe_lib
    card = card_line()
    if started is None:
        started = MoeQuant()
        started.start()
    with started.pool:
        one, one_s = started.wait()
    two, two_s = mf_world("moe-quant b", mq_rank_two, 2, "gloo")
    mark("phase 22's worlds")
    launches = dict.fromkeys(QMM_NAMES + ("flash_attention_fwd",), 0)
    # (a)
    r = one["moe_train"]
    if not r["same"]:
        fail(f"moe-quant[a {MOE_ARCH} train]: train(mesh=) on a world of 1 "
             f"is not train() bit for bit: {r['hist']}")
    launches["flash_attention_fwd"] += r["flash"]
    print(f"moe-quant[a nccl world of 1, {MOE_ARCH} {MQ_ONE_LAYERS} layers "
          f"full width, B={MQ_TRAIN_B} S={MQ_TRAIN_S}]: {MQ_STEPS} steps of "
          f"train(mesh=) bit-identical to train() (losses, grad norms, "
          f"every leaf): "
          + ", ".join(f"loss {lo:.6f} grad norm {gn:.5g}"
                      for lo, gn in r["hist"])
          + f"; steps {', '.join(f'{x:.3f}' for x in r['dt'])} s vs "
          f"{', '.join(f'{x:.3f}' for x in r['dt_unsharded'])} s "
          f"unsharded; peak {r['peak_gb']:.2f} GB; {r['flash']} flash "
          f"launches ({card})", flush=True)
    for bits in (8, 4):
        r = one[("serve", bits)]
        if not r["same"]:
            fail(f"moe-quant[a gemma2-2b int{bits}]: the sharded steps on "
                 f"stored weights are not the unsharded ones bit for bit")
        for k in launches:
            launches[k] += r["launches"][k]
        print(f"moe-quant[a nccl world of 1, gemma2-2b full width on int"
              f"{bits} codes]: prefill of {MQ_B} x {MQ_QS} and {MQ_DECODE} "
              f"decode steps through ShardedServeSteps bit-identical to the "
              f"unsharded steps (logits and cache digests); launches "
              f"{json.dumps(r['launches'])}; {r['s']:.2f} s ({card})",
              flush=True)
    print(f"moe-quant[a]: the world of 1 in {one_s:.1f} s", flush=True)
    # (b) moe_apply: the ranks' routes and plan are the one-device call's
    # on the global rows, exactly, and also the one-device dispatch of the
    # ranks' own routes
    want = one["moe_apply"]
    ranks = [t["moe_apply"] for t in two]
    idx = torch.cat([g["idx"] for g in ranks])
    moe = mq_config(MOE_ARCH, MQ_LAYERS).moe
    T, E = idx.shape[0], moe.num_experts
    C = moe_lib.capacity(T, moe)
    order, keep, dest = moe_lib.dispatch(idx, C, E)
    flat_keep, flat_slot = torch.empty_like(keep), torch.empty_like(dest)
    flat_keep[order] = keep
    flat_slot[order] = torch.where(keep, dest, -1)
    e_flat = idx.reshape(-1)
    got_keep = torch.cat([g["keep"] for g in ranks])
    got_slot = torch.cat([torch.where(g["keep"], g["slot"], -1)
                          for g in ranks])
    glob = torch.where(flat_keep, flat_slot - e_flat * C, -1)
    if not (torch.equal(got_keep, flat_keep) and torch.equal(got_slot,
                                                              glob)):
        fail(f"moe-quant[b moe_apply]: the ranks' plan is not the "
             f"one-device plan of their routes: keep differs at "
             f"{int((got_keep != flat_keep).sum())} pairs")
    flips = (idx != want["idx"]).any(-1)
    if flips.any():
        fail(f"moe-quant[b moe_apply]: {int(flips.sum())} of {T} rows route "
             f"otherwise than the one-device call on the global rows")
    want_slot = torch.where(want["keep"], want["slot"], -1)
    if not (torch.equal(got_keep, want["keep"])
            and torch.equal(got_slot, want_slot)):
        fail(f"moe-quant[b moe_apply]: the ranks' plan differs from the "
             f"one-device call's: keep at "
             f"{int((got_keep != want['keep']).sum())} pairs, slots at "
             f"{int((got_slot != want_slot).sum())}")
    y = torch.cat([g["y"] for g in ranks]).reshape(T, -1)
    wy = want["y"].reshape(T, -1)
    bad = mismatch(y, wy)
    if bad.any():
        fail(f"moe-quant[b moe_apply]: {int(bad.sum())} output elements "
             f"off the kernel bound, max |err| "
             f"{float((y - wy).abs().max()):.4g}")
    aux = [g["aux"] for g in ranks]
    if any(abs(a - want["aux"]) > 1e-5 * abs(want["aux"]) for a in aux):
        fail(f"moe-quant[b moe_apply]: aux {aux} vs {want['aux']}")
    dropped = int((~got_keep).sum())
    if not dropped:
        fail("moe-quant[b moe_apply]: the case drops no pair, so it cannot "
             "tell the global capacity from a rank's")
    local_c = moe_lib.capacity(T // 2, moe)
    print(f"moe-quant[b gloo data=2 {MOE_ARCH} full width, moe_apply on "
          f"{MQ_B} x {MQ_S} rows]: routes, keep and global slots equal to "
          f"the one-device call's on the global rows at C={C} "
          f"(min(C, T_local) = {min(C, T // 2)} rows an expert; a rank's "
          f"own capacity would be {local_c}), {dropped} of {idx.numel()} "
          f"pairs dropped; y within the kernel bound, max |err| "
          f"{float((y - wy).abs().max()):.4g}; aux {aux[0]:.6f} vs "
          f"{want['aux']:.6f} ({card})", flush=True)
    # (b) the prefill and training at data=2
    wl = one["moe_prefill"]
    for i, t in enumerate(two):
        got = t["moe_prefill"]["logits"]
        w = wl[i:i + 1]
        d = float((got - w).abs().max())
        if d > LOGIT_RTOL * float(w.abs().max()):
            fail(f"moe-quant[b {MOE_ARCH} prefill]: rank {i}'s logits "
                 f"differ by {d:.4g} of max |logit| {float(w.abs().max()):.4g}")
        launches["flash_attention_fwd"] += t["moe_prefill"]["flash"]
    print(f"moe-quant[b gloo data=2 {MOE_ARCH} {MQ_LAYERS} layers, prefill "
          f"B={MQ_B} S={MQ_S}]: each rank's logits within "
          + ", ".join(f"{float((t['moe_prefill']['logits'] - wl[i:i + 1]).abs().max() / wl[i:i + 1].abs().max()):.3g}"
                      for i, t in enumerate(two))
          + f" of max |logit| of the one-device prefill of the global batch "
          f"(tolerance {LOGIT_RTOL}); {two[0]['moe_prefill']['s']:.2f} s "
          f"({card})", flush=True)
    want = one["moe_train_ref"]["steps"]
    for i, t in enumerate(two):
        mq_hold_train(f"moe-quant[b {MOE_ARCH} train rank {i}]",
                      t["moe_train"]["steps"], want)
        launches["flash_attention_fwd"] += t["moe_train"]["flash"]
    t = two[0]["moe_train"]
    print(f"moe-quant[b gloo data=2 {MOE_ARCH} {MQ_LAYERS} layers train "
          f"B={MQ_TRAIN_B} S={MQ_TRAIN_S}]: against the one-device run on "
          f"the global batch: "
          + mq_hold_train("", t["steps"], want)
          + f"; steps {', '.join(f'{x:.2f}' for x in t['s'])} s "
          f"(host-staged gloo, not a speed), peaks "
          + ", ".join(f"{u['moe_train']['peak_gb']:.2f}" for u in two)
          + f" GB; {t['flash']} flash launches a rank ({card})", flush=True)
    # (b) one row at data=2: the sequence split over data, every rank
    # routing the whole rows as one device does
    want = one["moe_seq"]
    for i, t in enumerate(two):
        got = t["moe_seq"]
        if len(got["plans"]) != len(want["plans"]) or not all(
                torch.equal(a, b) for g, w in zip(got["plans"],
                                                   want["plans"])
                for a, b in zip(g, w)):
            fail(f"moe-quant[b {MOE_ARCH} B={MQ_SEQ_B} S={MQ_TRAIN_S}]: rank "
                 f"{i}'s routes, keep or slots differ from the one-device "
                 f"plan")
        if abs(got["loss"] - want["loss"]) > MT_LOSS_RTOL * abs(want["loss"]):
            fail(f"moe-quant[b {MOE_ARCH} B={MQ_SEQ_B}]: rank {i}'s loss "
                 f"{got['loss']} vs {want['loss']}")
        launches["flash_attention_fwd"] += got["flash"]
    kept = [int(k.sum()) for _, k, _ in want["plans"]]
    print(f"moe-quant[b gloo data=2 {MOE_ARCH} {MQ_LAYERS} layers, "
          f"Model.loss on B={MQ_SEQ_B} S={MQ_TRAIN_S}, the sequence split "
          f"over data]: every rank's routes, keep and buffer rows equal to "
          f"the one-device plan in all {len(want['plans'])} layers "
          f"(integers; pairs kept {kept} of "
          f"{want['plans'][0][0].numel()} a layer); loss "
          + ", ".join(f"{t['moe_seq']['loss']:.6f}" for t in two)
          + f" vs {want['loss']:.6f}; {two[0]['moe_seq']['flash']} flash "
          f"launches a rank, {two[0]['moe_seq']['s']:.2f} s ({card})",
          flush=True)
    # (b) stored codes at model=2; the sliced calls checked and timed here,
    # the card to themselves
    from repro_torch.models.api import build_model
    gemma = build_model(mq_config("gemma2-2b", MQ_LAYERS))
    for bits in (8, 4):
        want = one[("ref", bits)]
        worst = 0.0
        for i, t in enumerate(two):
            r = t[("serve", bits)]
            d = float((r["prefill"] - want["prefill"]).abs().max())
            if d > LOGIT_RTOL * float(want["prefill"].abs().max()):
                fail(f"moe-quant[b gemma2-2b int{bits}]: rank {i}'s "
                     f"prefill logits differ by {d:.4g}")
            worst = max(worst, ms_hold(
                f"moe-quant[b gemma2-2b int{bits} rank {i}]", r, want),
                d / float(want["prefill"].abs().max()))
            for k in launches:
                launches[k] += r["launches"][k]
        names = QMM_NAMES[:1] if bits == 8 else QMM_NAMES
        n = {k: sum(t[("serve", bits)]["launches"][k] for t in two)
             for k in names}
        if not all(n.values()):
            fail(f"moe-quant[b gemma2-2b int{bits}]: launches on the ranks' "
                 f"slices {n}")
        params = mq_stored(gemma, bits)
        checks = mq_slice_checks(params, bits)
        del params
        torch.cuda.empty_cache()
        print(f"moe-quant[b gloo model=2 gemma2-2b {MQ_LAYERS} layers on "
              f"int{bits} codes, B={MQ_B} prompt {MQ_QS}, {MQ_DECODE} "
              f"steps]: logits within {worst:.3g} of max |logit| of the "
              f"one-device steps (tolerance {LOGIT_RTOL}; the control, the "
              f"one-device decode with a bf16 ulp on a tenth of its "
              f"attention outputs: {one[('ulp', bits)]:.3g}), greedy tokens "
              f"equal where the margin allows; launches on the ranks' "
              f"column slices {json.dumps(n)}; each slice's call against "
              f"its plain version and the whole call's columns (kernel "
              f"bound): "
              + ", ".join(f"{s} {c['name'][13:18]} M={M} N={c['N'] // 2}/"
                          f"{c['N']} K={c['K']} |err| {c['plain_err']:.3g}"
                          f"/{c['err']:.3g} splits "
                          f"{c['splits'][0]}/{c['splits'][1]}, "
                          f"{c['ms']:.4f} ms (whole {c['whole_ms']:.4f}, "
                          f"bound {c['bound_ms']:.4f})"
                          for (s, M), c in checks.items())
              + f" ({card})", flush=True)
    want = one["haq_ref"]["steps"]
    for i, t in enumerate(two):
        mq_hold_train(f"moe-quant[b gemma2-2b HAQ rank {i}]",
                      t["haq"]["steps"], want)
    print(f"moe-quant[b gloo model=2 gemma2-2b {MQ_LAYERS} layers, HAQ "
          f"fake-quant step {json.dumps(MQ_HAQ)}]: against one device: "
          + mq_hold_train("", two[0]["haq"]["steps"], want)
          + f"; {two[0]['haq']['wall']:.1f} s ({card})", flush=True)
    print(f"moe-quant[b]: the world of 2 in {two_s:.1f} s", flush=True)
    return launches


# ------------------------- phase 23: the paper's tables and examples ----
# (a) and (c) run in a child process of their own (``Phase23``), started
# before phase 17 and collected after phase 18: the tables' tiny models and
# the examples are host-bound loops that leave the card mostly idle, as
# phases 17-18's host-staged gloo worlds do, so each pays for the other's
# time. (b) times the card, so it runs in this process after phase 22, the
# card to itself.
P23_NAS_STEPS = 20      # examples/torch_nas_specialize.py --steps (80)
P23_LM_STEPS = 20       # examples/torch_train_lm.py --steps (200)
P23_TIMEOUT_S = 900.0
# a HAQ best within its budget to float rounding (the back-off compares
# the same sum), or at every site's lowest bits where the budget is below
# what the back-off can reach (core/haq.py::enforce_budget)
P23_REL = 1e-6


def p23_example(name):
    """The module of examples/<name>.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p23_numbers(derived):
    """{key: float} of the numbers in a row's ``derived`` (``k=v;...``,
    units x, xbudget, s and us stripped); flags and architectures left
    out."""
    out = {}
    for kv in derived.split(";"):
        k, _, v = kv.partition("=")
        for unit in ("xbudget", "x", "s"):
            if v.endswith(unit) and v[:-len(unit)].lstrip("+-")[:1] \
                    .isdigit():
                v = v[:-len(unit)]
                break
        try:
            out[k] = float(v)
        except ValueError:
            pass
    return out


def p23_hold_tables(results):
    """Phase 23(a)'s checks on tables/run.py's results: every row's
    us_per_call and derived numbers finite; each HAQ best within its
    budget (or at the back-off's floor); each AMC best within its FLOPs
    target. Returns the number of rows."""
    from repro_torch.core import haq
    n = 0
    for tag, res in results.items():
        for name, us, derived in res["rows"]:
            nums = p23_numbers(derived)
            if not math.isfinite(us) or not all(
                    math.isfinite(v) for v in nums.values()):
                fail(f"tables[{tag}]: {name} has a non-finite number: "
                     f"{us}, {derived}")
            n += 1
        for best in res["haq"]:
            floor = all(b == (min(haq.W_BITS), min(haq.A_BITS))
                        for b in best["policy"].values())
            if best["resource"] > best["budget"] * (1 + P23_REL) \
                    and not floor:
                fail(f"tables[{tag}]: a HAQ best uses {best['resource']!r}"
                     f" of a budget of {best['budget']!r}")
        for best, target in res["amc"]:
            if best["flops_frac"] > target + 1e-6:
                fail(f"tables[{tag}]: an AMC best keeps "
                     f"{best['flops_frac']!r} of the FLOPs, target "
                     f"{target}")
    return n


def p23_quant_dot(policy, mode):
    """make_quant_dot(policy, use_kernel=True)'s hook with its quant
    matmuls in ``mode`` ("cuda": the kernels; "ref": their plain
    versions), as phase 6 runs W8A8 both ways."""
    from repro_torch.core.quantization import make_quant_dot
    from repro_torch.kernels import ops as kops
    fake = make_quant_dot(policy)

    def dot(x, w, name, amax=None):
        if name in policy and w.dim() == 2 and policy[name][0] <= 8:
            w_bits, a_bits = policy[name]
            return kops.quant_matmul(x, w, w_bits=int(w_bits),
                                     a_bits=int(a_bits), mode=mode)
        return fake(x, w, name, amax)
    return dot


def p23_teacher_forced(model, params, tokens, S, dot, kernel):
    """``generate``'s path fed ``tokens`` after the S-token prompt: the
    prefill, then paged decode steps over the identity page pool; (steps,
    V) fp32 logits, row i predicting tokens[:, S + i]."""
    import torch
    from repro_torch.launch import serve
    B, T = tokens.shape
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens[:, :S]},
                                      cache_layout="full", dot=dot,
                                      kernel=kernel)
        pool, pt = serve._identity_paged_pool(cache, B, T, PAGE)
        out = [logits[:, -1].float()]
        for t in range(S, T - 1):
            pos = torch.full((B,), t, dtype=torch.int32,
                             device=tokens.device)
            logits, pool = model.decode_step_paged(
                params, pool, pt, tokens[:, t:t + 1], pos, kernel=kernel,
                dot=dot)
            out.append(logits[:, 0].float())
    return torch.cat(out)


def p23_expected_quant(cfg, policy, forwards):
    """The quant matmul launches ``forwards`` forwards through the hook
    make: every 2-D site of the policy (the FFN's; the attention
    projections are 3-D, fake-quantized), a kernel by its bits, once a
    layer."""
    want = dict.fromkeys(QMM_NAMES + ("quant_matmul_w8a8",), 0)
    for site in ("ffn_in", "ffn_gate", "ffn_out"):
        if site not in policy:
            continue
        w, a = policy[site]
        name = "quant_matmul_w4a16" if w <= 4 else \
            "quant_matmul_w8a8" if a <= 8 else "quant_matmul_w8a16"
        want[name] += cfg.num_layers * forwards
    return want


def p23_examples():
    """Phase 23(c): the four examples on the card, each's launches zeroed
    before it and read after. Returns ({example: launches}, seconds)."""
    import torch
    launches, secs = {}, {}
    runs = (("torch_quickstart", []),
            ("torch_compress_pipeline", []),
            ("torch_nas_specialize", ["--steps", str(P23_NAS_STEPS)]),
            ("torch_train_lm", ["--steps", str(P23_LM_STEPS)]))
    outs = {}
    for name, argv in runs:
        with tempfile.TemporaryDirectory() as tmp:
            if name == "torch_train_lm":
                argv = argv + ["--ckpt-dir", tmp]
            torch.cuda.synchronize()
            reset_all_launches()
            t0 = time.perf_counter()
            print(f"# example {name} {' '.join(argv)}", flush=True)
            outs[name] = p23_example(name).main(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            launches[name] = {k: v for k, v in all_launches().items() if v}
    # quickstart: 8 tokens from 2 prompts, 7 paged decode steps a layer
    q = outs["torch_quickstart"]
    L = q["model"].cfg.num_layers
    if launches["torch_quickstart"] != {"paged_attention_fwd": 7 * L}:
        fail(f"examples[quickstart]: launches "
             f"{launches['torch_quickstart']}, want 7 x {L} paged decode")
    p23_stage3(outs["torch_compress_pipeline"],
               launches["torch_compress_pipeline"])
    nas = outs["torch_nas_specialize"]["search"]
    if not (math.isfinite(nas["e_lat_us"]) and len(nas["arch"]) == 6):
        fail(f"examples[nas_specialize]: {nas['arch']}, {nas['e_lat_us']}")
    lm = outs["torch_train_lm"]
    h = lm["history"]
    rounded = {k: round(v, 1) for k, v in secs.items()}
    print(f"examples: seconds {json.dumps(rounded)}; train_lm loss "
          f"{h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} over {P23_LM_STEPS} "
          f"steps at B 8 x 128, {lm['tokens'] / lm['seconds']:.0f} tok/s; "
          f"nas_specialize ({P23_NAS_STEPS} steps) arch "
          f"{'|'.join(nas['arch'])}", flush=True)
    return launches, secs


def p23_stage3(out, launches):
    """compress_pipeline's stage 3 on the card: the quant matmul and paged
    decode launches its generate makes (8 forwards: the prefill and 7
    decode steps), and its logits teacher-forced on the served tokens
    through the kernels against the kernels' plain versions (the same
    hook, ``mode="ref"``, and the plain paged walk) under phase 3's rule;
    the kernel path's greedy tokens must be the served ones. Printed
    beside them: the same policy through the plain fake-quant hook
    (``use_kernel=False``), which quantizes otherwise (W4A16 keeps x at
    16 bits where the policy asks fewer; 5-7-bit weights run as int8
    codes; W8A8's activations per tensor, not PACT), so it is a
    different model and its gap is not gated."""
    import torch
    from repro_torch.core.quantization import make_quant_dot
    model, params, pol = out["model"], out["pruned"], out["policy"]
    toks, S = out["tokens"], out["prompt"].shape[1]
    cfg = model.cfg
    want = p23_expected_quant(cfg, pol, 8)
    want["paged_attention_fwd"] = 7 * cfg.num_layers
    got = {k: launches.get(k, 0) for k in want}
    if got != want or not any(launches.get(k, 0) for k in QMM_NAMES):
        fail(f"examples[compress stage 3]: launches {launches}, want "
             f"{want} (policy {pol}) and W8A16 or W4A16 among them")
    kern = p23_teacher_forced(model, params, toks, S,
                              p23_quant_dot(pol, "cuda"), "cuda")
    plain = p23_teacher_forced(model, params, toks, S,
                               p23_quant_dot(pol, "ref"), "ref")
    if not torch.equal(kern.argmax(-1).to(torch.int32), toks[0, S:]):
        fail(f"examples[compress stage 3]: the kernel path's greedy tokens "
             f"{kern.argmax(-1).tolist()} are not the served "
             f"{toks[0, S:].tolist()}")
    compare_logits("examples[compress stage 3]",
                   "8 teacher-forced steps, quant matmuls and paged decode",
                   kern, plain)
    hook = p23_teacher_forced(model, params, toks, S, make_quant_dot(pol),
                              "ref")
    clear = (hook.topk(2, -1).values[:, 0] - hook.topk(2, -1).values[:, 1]
             ) > LOGIT_RTOL * float(hook.abs().max())
    same = kern.argmax(-1) == hook.argmax(-1)
    print(f"examples[compress stage 3]: served tokens "
          f"{toks[0, S:].tolist()}; policy {json.dumps(pol)}; launches "
          f"{json.dumps(got)}; the plain fake-quant hook (another "
          f"quantizer, not gated): max |logit diff| "
          f"{float((kern - hook).abs().max()):.4g} of |logit| up to "
          f"{float(hook.abs().max()):.3g}, greedy tokens equal at "
          f"{int(same.sum())} of {len(same)} steps ({int(clear.sum())} "
          f"with a top-2 margin past {LOGIT_RTOL})", flush=True)


def p23_child():
    """Phase 23(a) and (c) in a child process: every table section
    (tables/run.py) at the reference's sizes on the card, then the four
    examples. Returns {"text": what it printed, "rows", "launches",
    "seconds"}; a failure raises, its printed text in the message."""
    import io
    import os
    import torch
    from repro_torch.tables import run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the phases beside it stage their gloo collectives through the host:
    # its host work (the agents, the launch loops) takes one core, and
    # only what they leave
    torch.set_num_threads(1)
    os.nice(10)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            results, failures = run.run_sections(device="cuda")
            if failures:
                fail(f"tables: {len(failures)} sections failed: {failures}")
            n = p23_hold_tables(results)
            t_tables = time.perf_counter() - t0
            launches, secs = p23_examples()
    except BaseException as e:          # noqa: BLE001
        raise SystemExit(f"chip_smoke: FAILED: phase 23: {e}\n--- its "
                         f"output ---\n{buf.getvalue()[-12000:]}") from None
    return {"text": buf.getvalue(), "rows": n, "launches": launches,
            "seconds": {"tables": t_tables, **secs,
                        "all": time.perf_counter() - t0}}


class Phase23:
    """Phase 23(a, c) in a spawned child process (``p23_child``), started
    by ``start`` and collected by ``result``."""

    def __init__(self):
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        self.t0 = time.perf_counter()
        self.future = self.pool.submit(p23_child)

    def result(self):
        """(the child's result, seconds from its start to its collection);
        the child's failure ends the run."""
        try:
            out = self.future.result(timeout=P23_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            for proc in list(self.pool._processes.values()):
                proc.kill()
            fail(f"phase 23: the child ran past {P23_TIMEOUT_S} s")
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
        return out, time.perf_counter() - self.t0


def p23_fig4(card):
    """Phase 23(b), Fig. 4 at full width: granite-3-8b's first six decode
    sites, M = 1 bf16 x against the site's whole K x N, the bf16 product
    (torch.matmul) and the W8A16 and W4A16 kernels on the site's codes,
    each call timed on the device over cold weight copies and held to its
    plain version on the same codes (phase 2's bound), printed beside
    h100-sxm's roofline for one layer's call and for the site's layers
    (``site.latency``). Returns rows of {site, K, N, ms by kernel,
    predicted}."""
    import torch
    from repro_torch.core.hardware_model import H100_SXM
    from repro_torch.tables.roofline_report import fig4_sites
    g = torch.Generator(device="cuda").manual_seed(23)
    specs = qmm_specs()
    rows = []
    for site in fig4_sites():
        K, N = site.d_in, site.d_out
        x = torch.randn((1, K), generator=g, device="cuda").bfloat16()
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        wb = w.bfloat16()
        copies = max(1, -(-QMM_COLD_BYTES // wb.nbytes))
        ms = {"bf16": device_ms(torch.matmul, [(x, wb)] + [
            (x, wb.clone()) for _ in range(copies - 1)])}
        err = {}
        for name in ("quant_matmul_w8a16", "quant_matmul_w4a16"):
            fwd, plain, quantize = specs[name]
            codes, scale = quantize(w)
            err[name] = check_qmm(name, fwd, plain, x, codes, scale,
                                  f"fig4 {site.name} {K} x {N}")
            fn, _, args = qmm_call(name, x, codes, scale)
            ms[name] = device_ms(fn, cold_weight_sets(args))
            del codes, scale
        pred = {b: site.latency(H100_SXM, b, 16) / site.count * 1e3
                for b in (16, 8, 4)}
        rows.append({"site": site.name, "K": K, "N": N, "layers":
                     site.count, "ms": ms, "pred_ms": pred, "err": err})
        print(f"fig4[{site.name} {K} x {N}, M = 1]: measured bf16 "
              f"{ms['bf16']:.4f} ms, W8A16 {ms['quant_matmul_w8a16']:.4f} "
              f"ms, W4A16 {ms['quant_matmul_w4a16']:.4f} ms a call; "
              f"h100-sxm roofline predictions (16,16) {pred[16]:.4f}, "
              f"(8,16) {pred[8]:.4f}, (4,16) {pred[4]:.4f} ms a call, "
              f"{site.latency(H100_SXM, 16, 16) * 1e3:.4f}, "
              f"{site.latency(H100_SXM, 8, 16) * 1e3:.4f}, "
              f"{site.latency(H100_SXM, 4, 16) * 1e3:.4f} ms over its "
              f"{site.count} layers; measured over predicted "
              f"{ms['bf16'] / pred[16]:.2f}x, "
              f"{ms['quant_matmul_w8a16'] / pred[8]:.2f}x, "
              f"{ms['quant_matmul_w4a16'] / pred[4]:.2f}x; max |err| vs "
              f"plain W8A16 {err['quant_matmul_w8a16']:.3g}, W4A16 "
              f"{err['quant_matmul_w4a16']:.3g} ({card})", flush=True)
        del w, wb
        torch.cuda.empty_cache()
    return rows


def phase_tables(p23, card):
    """Phase 23(a, c): collect the child (``Phase23``) and print every
    table row under the card's line. Returns the launches of the examples'
    paths, summed: {kernel: n}."""
    out, secs = p23.result()
    print(f"tables: {card}; us_per_call as each section's '# <tag>: "
          f"us_per_call is' line says (measured host time on this card, or "
          f"an h100 roofline prediction); the sim_lat_us, lat_* and t_* "
          f"fields are roofline predictions on the h100 targets, never "
          f"measured", flush=True)
    for line in out["text"].splitlines():
        print(f"tables| {line}", flush=True)
    total = {}
    for runs in out["launches"].values():
        for k, v in runs.items():
            total[k] = total.get(k, 0) + v
    examples = {k: round(v, 1) for k, v in out["seconds"].items()
                if k.startswith("torch_")}
    print(f"tables: phase 23 (a, c) {out['rows']} rows in the child's "
          f"{out['seconds']['all']:.1f} s (tables "
          f"{out['seconds']['tables']:.1f} s; examples "
          f"{json.dumps(examples)}), collected {secs:.1f} s after its "
          f"start; launches of the examples' paths {json.dumps(total)}",
          flush=True)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models.api import build_model
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    secs = build.build_all()
    print(f"build: {json.dumps(secs)} s of nvcc, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mark("phase 1")
    # phase 19(c)'s two-pod cells trace on the host beside phases 1b-16
    micro = DrySweep(dry_micro_runs(), nice=19)

    phase_tiny_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        policy_file = Path(tmp) / "kv_policy.json"
        policy_file.write_text(json.dumps(KV_POLICY))
        phase_tiny_engine(policy_file)
    phase_tiny_moe_engine()
    mark("phases 1b-1d")

    model = build_model(get_config("gemma2-2b"))
    moe_model = build_model(get_config(MOE_ARCH))
    from repro_torch.launch import serve

    def probe(m):
        return serve.make_policy(
            m.cfg, m, serve.build_parser().parse_args(
                ["--arch", m.cfg.name, "--max-batch", "8"]),
            max(len(r.prompt) + r.max_new for r in main_trace(m.cfg)))

    gp, mp = probe(model), probe(moe_model)
    records = phase_kernels(prefill_chunk=gp.prefill_chunk,
                            n_blocks_main=gp.pages_per_seq)
    records["flash_attention_fwd"] = phase_flash_kernels()
    records.update(phase_qmm_kernels())
    moe_records = phase_moe_kernels(prefill_chunk=mp.prefill_chunk,
                                    n_blocks_main=mp.pages_per_seq)
    mark("phases 2-2b")

    t1 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    print(f"model: gemma2-2b {model.param_count()} params "
          f"({model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    phase_model(model, params)
    phase_model_whole(model, params)
    phase_model(model, params, kv_bits=KV_POLICY, ticks=3)
    for w_bits in (8, 4):
        phase_model(model, params, w_bits=w_bits)
    mark("phase 3")
    launches, policy, args, bf16_summary = phase_engine(model, params)
    phase_profile(model, params, policy, args)
    wp_launches, wp_policy, wp_args, _ = phase_engine(
        model, params, ["--no-chunked-prefill"], expect=WHOLE_KERNELS,
        bf16_summary=bf16_summary)
    phase_profile(model, params, wp_policy, wp_args)
    with tempfile.TemporaryDirectory() as tmp:
        policy_file = Path(tmp) / "kv_policy.json"
        policy_file.write_text(json.dumps(KV_POLICY))
        q_launches, q_policy, q_args, _ = phase_engine(
            model, params, ["--kv-policy", str(policy_file)],
            expect=QUANT_KERNELS, bf16_pages=policy.num_pages,
            bf16_summary=bf16_summary)
    phase_profile(model, params, q_policy, q_args)
    w_launches, w_policy, w_args, _ = phase_engine(
        model, params, expect=WQ_KERNELS, quant_bits=WQ_BITS,
        bf16_summary=bf16_summary)
    phase_profile(model, params, w_policy, w_args)
    mark("phases 4-5")
    phase_generate(model, params)
    phase_generate_long(model, params)
    g_launches = phase_generate_quant(model, params)
    phase_drift(model, params)
    mark("phases 6-7")
    t_haq = time.perf_counter()
    phase_haq_kv(model, params, policy.num_pages, bf16_summary)
    t_w = time.perf_counter()
    phase_haq_weights(model, params)
    t_a = time.perf_counter()
    phase_autotune()
    print(f"haq: KV part {t_w - t_haq:.1f} s, weight part {t_a - t_w:.1f} "
          f"s, autotune part {time.perf_counter() - t_a:.1f} s", flush=True)
    mark("phase 8")
    t_amc = time.perf_counter()
    amc_gemma = phase_amc(model, params)

    # gemma2-2b's parameters go before granite-moe's are made
    del params
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    moe_params = moe_model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"model: {MOE_ARCH} {moe_model.param_count()} params "
          f"({moe_model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    amc_moe = phase_amc(moe_model, moe_params)
    t_serve = time.perf_counter()
    moe_launches, _ = phase_moe_serve(moe_model, moe_params, bf16_summary)
    del moe_params
    torch.cuda.empty_cache()
    print(f"granite-moe: kernels at G=3 {json.dumps(moe_records)}; "
          f"launches on its served trace "
          f"{json.dumps({k: moe_launches[k] for k in BF16_KERNELS})}; "
          f"AMC s per episode gemma2-2b {amc_gemma['s_per_episode']:.3f}, "
          f"{MOE_ARCH} {amc_moe['s_per_episode']:.3f}; AMC part "
          f"{t_serve - t_amc:.1f} s, serving part "
          f"{time.perf_counter() - t_serve:.1f} s", flush=True)
    mark("phases 9-10")

    # phase 12: the training path, every serving parameter freed
    t_train = time.perf_counter()
    bwd_row = phase_train_flash()
    state, train_launches, train_step_s, train_peak = phase_train_full()
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    phase_train_grads(params)
    del params
    torch.cuda.empty_cache()
    phase_train_resume()
    print(f"train: flash backward {json.dumps(bwd_row)}; whole-prompt "
          f"serving path's flash launches {wp_launches['flash_attention_fwd']}"
          f"; phase 12 in {time.perf_counter() - t_train:.1f} s", flush=True)
    mark("phase 12")

    # phase 13: the SSM family and the dense-cache decode
    t_ssm = time.perf_counter()
    ssm_flash = phase_ssm_flash()
    ssm_launches = {arch: phase_ssm_serve(arch) for arch in SSM_ARCHS}
    ring_flash = phase_ring_decode()
    t_nas = time.perf_counter()
    # phase 14: the NAS search
    nas_flash = phase_nas()
    flash_paths = {
        "train": train_launches["flash_attention_fwd"],
        **{f"generate {a}": n["flash_attention_fwd"]
           for a, n in ssm_launches.items()},
        "ring prefill gemma2-2b": ring_flash, "nas search": nas_flash}
    print(f"ssm+nas: flash at the new geometries {json.dumps(ssm_flash)}; "
          f"flash launches by path {json.dumps(flash_paths)}; phase 13 in "
          f"{t_nas - t_ssm:.1f} s, phase 14 in "
          f"{time.perf_counter() - t_nas:.1f} s", flush=True)
    mark("phases 13-14")

    # phases 15-16: the encoder-decoder and the vision stub at full width
    t_ed = time.perf_counter()
    ed_rows = phase_new_flash_geometries()
    w_serve = phase_whisper_serve()
    t_wt = time.perf_counter()
    w_train = phase_whisper_train()
    t_ll = time.perf_counter()
    ll = phase_llava()
    mark("phases 15-16")
    # phase 19(c)'s sweep traces on the host while phases 17-21 run
    sweep = DrySweep(dry_runs())
    # phase 21's world of 1 starts here and runs beside phase 17's worlds
    families = MeshFamilies()
    families.start_one()
    # phase 22(a)'s world follows phase 21's world of 1 on the card
    moe_quant = MoeQuant()
    moe_quant.start(after=families.one)
    # phase 23(a, c)'s child runs beside phases 17-18
    p23 = Phase23()
    # phase 17: the sharded engine
    t_mesh = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        policy_file = Path(tmp) / "kv_policy.json"
        policy_file.write_text(json.dumps(KV_POLICY))
        mesh_launches = phase_mesh(policy_file)
    print(f"mesh: phase 17 in {time.perf_counter() - t_mesh:.1f} s; "
          f"launches over its sharded runs, summed over ranks "
          f"{json.dumps({k: v for k, v in mesh_launches.items() if v})}",
          flush=True)
    mark("phase 17")
    moe_quant.wait()
    # phase 18: training split over a mesh
    t_mt = time.perf_counter()
    mt_flash, mt_rest = phase_train_mesh(train_step_s)
    print(f"mesh-train: phase 18 in {time.perf_counter() - t_mt:.1f} s; "
          f"flash launches over its sharded runs, summed over ranks "
          f"{mt_flash}", flush=True)
    mark("phase 18")
    # phase 23(a, c): the paper's tables and the examples, from the child
    p23_launches = phase_tables(p23, card_line())
    mark("phase 23 (a, c)")
    # phase 21's gloo world starts here and runs beside phases 19-20
    families.start_two()
    # phase 19: the dry-run and the roofline; (c) after phase 21
    t_dry = time.perf_counter()
    phase_dryrun(train_step_s, train_peak, mt_rest)
    print(f"dryrun: phase 19 (a, b) in {time.perf_counter() - t_dry:.1f} s",
          flush=True)
    mark("phase 19 (a, b)")
    # phase 20: the sharded prefill and serve steps
    t_ms = time.perf_counter()
    ms_flash = phase_mesh_serve()
    print(f"mesh-serve: phase 20 in {time.perf_counter() - t_ms:.1f} s; "
          f"flash launches of its sharded prefills, summed over ranks "
          f"{ms_flash}", flush=True)
    mark("phase 20")
    # phase 21: the ssm, hybrid, encdec and vlm families over a mesh
    t_mf = time.perf_counter()
    mf_flash = phase_mesh_families(families)
    print(f"mesh-families: phase 21 in {time.perf_counter() - t_mf:.1f} s "
          f"after phase 20 ({time.perf_counter() - families.t0:.1f} s since "
          f"its gloo world started, before phase 19); flash launches of its "
          f"sharded runs, summed over ranks {mf_flash}", flush=True)
    mark("phase 21")
    # phase 22: moe over data ranks, stored and fake-quantized weights
    # under a model split
    t_mq = time.perf_counter()
    mq_launches = phase_moe_quant(moe_quant)
    print(f"moe-quant: phase 22 in {time.perf_counter() - t_mq:.1f} s after "
          f"phase 21; launches of its sharded runs, summed over ranks "
          f"{json.dumps(mq_launches)}", flush=True)
    mark("phase 22")
    # phase 23(b): Fig. 4 at full width, the card to itself
    t_fig4 = time.perf_counter()
    p23_fig4(card_line())
    print(f"fig4: phase 23(b) in {time.perf_counter() - t_fig4:.1f} s",
          flush=True)
    mark("phase 23(b)")
    t_dry = time.perf_counter()
    phase_dryrun_sweep(sweep, micro)
    print(f"dryrun: phase 19(c) waited {time.perf_counter() - t_dry:.1f} s "
          f"for its sweep", flush=True)
    mark("phase 19(c)")
    ed_paths = {"whisper serve": w_serve["flash_attention_fwd"],
                "whisper train": w_train["flash_attention_fwd"],
                "llava prefill": ll["prefill"]["flash_attention_fwd"],
                "mesh": mesh_launches["flash_attention_fwd"],
                "mesh train": mt_flash, "mesh serve": ms_flash,
                "mesh families": mf_flash,
                "moe quant": mq_launches["flash_attention_fwd"]}
    flash_paths.update(ed_paths)
    print(f"encdec+vlm: kernels at the new geometries {json.dumps(ed_rows)};"
          f" flash launches by path {json.dumps(ed_paths)}; paged decode "
          f"launches on llava's paged steps "
          f"{ll['paged']['paged_attention_fwd']}; phase 15 in "
          f"{t_ll - t_ed:.1f} s (training {t_ll - t_wt:.1f} s), phase 16 "
          f"in {t_mesh - t_ll:.1f} s", flush=True)

    # launches per kernel from the run of the path it serves (flash: the
    # training path's, the SSM family's, the ring prefill's, the NAS
    # search's and phases 15-16's, summed; the paged decode: the engine's
    # main trace and llava's paged steps)
    launches = dict(launches, paged_attention_fwd=launches[
        "paged_attention_fwd"] + ll["paged"]["paged_attention_fwd"]
        + mesh_launches["paged_attention_fwd"]
        + p23_launches.get("paged_attention_fwd", 0),
        paged_prefill_fwd=launches["paged_prefill_fwd"]
        + mesh_launches["paged_prefill_fwd"])
    q_launches = {k: q_launches[k] + mesh_launches[k] for k in QUANT_KERNELS}
    w_launches = {k: w_launches[k] + mq_launches[k]
                  + p23_launches.get(k, 0) for k in QMM_NAMES}
    g_launches = {"quant_matmul_w8a8": g_launches["quant_matmul_w8a8"]
                  + p23_launches.get("quant_matmul_w8a8", 0)}
    source_run = {**{k: launches for k in BF16_KERNELS},
                  **{k: q_launches for k in QUANT_KERNELS},
                  "flash_attention_fwd": {
                      "flash_attention_fwd": sum(flash_paths.values())},
                  "quant_matmul_w8a16": w_launches,
                  "quant_matmul_w4a16": w_launches,
                  "quant_matmul_w8a8": g_launches}
    line = {"kernels": []}
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        r = records[name]
        n = source_run[name][name]
        line["kernels"].append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_line())
    print(json.dumps(line))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
