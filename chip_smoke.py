#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py             # from the repository root, no arguments
    python3 chip_smoke.py --cpu-gates # the lattice and sparse main paths with
                                      # backend="ref" on the CPU, 256 chains:
                                      # the gates' calibration (no card needed)

Phases, each printed as one JSON line; any failure raises and the script
exits nonzero without printing the final result line:

  1. device   — the card's name and power limit (nvidia-smi), its compute
                capability (must be 9.0), and the nvcc build of the kernels
                in src/repro_torch/kernels/csrc (one nvcc per source, run
                together), with ptxas's registers and spills.
     sass     — the toolkit's cuobjdump -sass of libflash_attention.so,
                libtau_leap.so, libdense_field.so, libsparse_fields.so,
                libcolored_gibbs.so, libcolored_gibbs_long.so,
                libsparse_energy.so, liblattice_gibbs.so and
                liblattice_energy.so: the count of
                HGMMA, UTMALDG, LDGSTS, IMMA, LDG and LDS instructions in
                each kernel, and ptxas's registers and spills of the two
                sparse libraries, the two lattice libraries and the tau-leap
                library (the fault variants' among them). Fails
                unless every bf16 flash kernel has HGMMA (wgmma) and UTMALDG
                (TMA loads), and the int8 kernels LDGSTS (cp.async) and IMMA.
  2. check    — each dense kernel against its plain PyTorch version on the
                card at (B, N) = (1,5) (8,64) (3,130) (64,300) (256,2048)
                (3,4099), asymmetric random int8 J: dense_field's int32
                accumulators exactly, its fields within 1 ulp;
                tau_leap_step's spins equal except where |u - p| <= 1e-6 (p
                from the plain version).
     check_lattice — lattice_gibbs_sweep against its plain version at
                (B,H,W) = (1,1,1) (8,8,8) (4,16,16) (2,32,24) (3,17,23)
                (16,128,128) (4096,16,16) (1,200,200), random asymmetric w,
                random frozen masks, king colour masks (random, improper
                ones at (8,8,8)), per-row beta in [0.3, 3], through both
                kernels, each launch's route asserted from the counters:
                the plan kernel wherever the masks are independent sets
                and every list fits a block's threads (all but (8,8,8),
                (16,128,128) and (1,200,200), which take the generic
                kernel by the plan's own choice), the two-buffer
                lattice_gibbs_generic everywhere (forced by a plan marked
                not independent).
                Spins equal except where |u - p_up| <= 1e-6 in the site's
                phase, frozen sites equal to the clamp value, and the
                fields probed through p_up (uniforms set to the plain p_up
                and one ulp below it; one phase per king colour on the plan
                kernel, one all-sites phase on the generic one) equal bit
                for bit. The same in bf16 (all seven operands bf16, beta
                f32), where the fields are probed with the two bf16
                uniforms that bracket the plain p_up, at beta = +-16^k
                (k < 6): equal wherever the probe can tell a field from its
                bf16 neighbours (the share is printed). Then the plan
                ChromaticGibbs.init builds for CAL: equal to the wrapper's
                own, and the sweep over it equal to the sweep over that.
     check_sparse — sparse_fields and colored_gibbs_sweep at (B, n, graph) =
                (1, 5, dense random, random improper masks) (8, 100,
                density 0.4) (3, 130, ragged)
                (256, 16384, random_3regular_maxcut) (2, 40000, 3-regular)
                (2, 65536, 3-regular: rows too long to stage, the
                sparse_fields_global kernel) (298, 4096, 3-regular: three
                staged rows a block, one in the last; the cases take
                every rows count the wrapper can pick): fields within 2^-22
                (sum_k |w_ik| + |b_i|), exactly for unit weights; spins
                equal except where |u - p_up| <= beta_r/2 * that bound +
                1e-6; each fields launch counted under the variant its n
                takes; and, for each problem's own colouring, the sweep over
                the colour plan that ColoredGibbs.init builds equal to the
                sweep over the wrapper's own plan.
     check_flash — flash_attention against its plain version at (BH, Sq,
                Sk, d, causal, dtype) = the JAX test's grid (2,256,256,64,
                causal, f32) (4,128,384,32, f32) (1,512,512,128, causal,
                bf16) (2,256,256,64, causal, bf16); causal Sq != Sk
                (2,256,128,64, f32) (2,128,384,64, bf16); (1,256,256,256,
                causal, f32); the two full-width shapes of main_attention
                in f32; d = 8, 40 and 136 (partial column groups); the bf16
                kernel (wgmma) also at (4,128,384,32) and (3,128,256,8,
                causal), f32 running on the CUDA-core kernel: within
                atol = rtol = 2e-5 (f32) and 2e-2 (bf16), the JAX test's
                bounds, and in bf16 also within one bf16 ulp (2^-7 |o| +
                1e-6) of the plain version's f32 result; then the key-length
                bound (slice 11), non-causal, f32 and bf16, at (BH, Sq, Sk,
                d, kv_len) = (16, 1536, 1536, 64, 1500) (whisper-medium's
                encoder) (16, 128, 1536, 64, 1500) (its cross-attention's
                prefill) (4, 128, 384, 32, 200) (mid-tile) (2, 256, 512, 64,
                384) (a tile's edge), the same bounds; kv_len = Sk equal to
                the unbounded launch bit for bit, and kv_len < Sk with the
                causal mask refused before any launch.
     check_flash_window — the sliding-window band (slice 10) on both
                kernels, f32 and bf16, at (BH, S, d, window) = (16, 4096,
                256, 2048) (recurrentgemma-9b's attn_local prefill) and (4,
                512, 64, 200) (a window across tiles, no multiple of 128):
                the same bounds against the banded plain version; a window
                of S and of S + 77 equal to the causal launch bit for bit.
  3. timing   — CUDA-event median of each kernel at its main path's shape,
                beside its plain version, the library call that computes the
                same function where there is one (torch._int_mm for the int8
                product, torch.sparse.mm for the sparse fields,
                scaled_dot_product_attention for attention; timed here
                only) and the device bound; the lattice sweep in f32 and
                bf16 over the plan, beside its sector floor (the bytes of
                the 32-byte sectors its uniforms touch in the (C, B, H, W)
                layout) and beside the generic kernel at the same shape
                and at (8, 8, 8) with random masks, and the wrapper's host
                cost per call at the CAL shape (the launch replaced by
                nothing; check_plan alone); flash_attention at both
                main_attention shapes; the coloured sweep also beside its
                sector floor (in the (C, B, n) layout);
                sparse_fields_global at (64, 65536); the band at (16, 4096,
                256), window 2048, bf16, beside SDPA with the band as a
                boolean attn_mask (timing_attention_window); the key-length
                bound at (16, 1536, 64), kv_len 1500, bf16, beside SDPA on
                the 1500 unpadded keys (timing_attention_kv_len).
  4. main     — sampler_api.run(TauLeap(dt=0.1), backend="cuda") on SK
                n=2048 seed 0, 256 chains x 2000 steps, geometric(0.3, 3.0)
                annealing, with and without first_hit, and the same run on
                backend="ref"; then the int8 fields of the final states
                through ops.dense_field. Each path's launches are read
                as the change of tracing.counts()'s launch.* counts over
                it; under the CUDA graph of run()'s step loop they count
                the launches the replays ran.
     main_lattice — ChromaticGibbs on cal_problem() (the chip's 16x16 core),
                4096 chains x 500 sweeps, geometric(0.3, 3.0), the same
                three runs with first_hit = the template energy: hit
                fraction >= 0.5 on both backends, within 0.05 of each other;
                then a clamped-conditional run (top half clamped to the
                template): clamped half exact, free half agreement > 0.9.
     main_sparse — ColoredGibbs on random_3regular_maxcut(16384, 0), 256
                chains x 1000 sweeps, the same three runs: cut fraction of
                the edges >= 0.85, cuda and ref within 1%, the cuda runs'
                energies through the sparse energy kernel; then the fields
                of the final states through ops.sparse_fields (1 launch):
                0.5 s.h + b.s equals SparseIsing.energy exactly.
     main_attention — ops.flash_attention at the prefill attention of two
                full-width configs, batch 1, S = 4096 (train_4k), causal,
                bf16: phi4-mini-3.8B (24 query heads, 8 KV heads repeated
                to 24, d = 128) and gemma-2b (8 query heads, 1 KV head,
                d = 256); one kernel launch each, held against the plain
                version as check_flash holds bf16 (2e-2, and one bf16 ulp
                of the f32 result); the launch counted as bf16 (the wgmma
                kernel), none as f32.
  5. stats    — a grid-exact n=5 problem through the tau_leap_step kernel,
                64 chains x 16000 steps: TV distance to exact enumeration.
     stats_gibbs — TV to exact enumeration below 0.03 for a 2x3 lattice with
                random couplings and one clamped site (lattice kernel) and
                an 8-site random weighted graph (coloured kernel).
  6. graph_vs_eager — every run() above replays captured CUDA graphs of
                blocks of steps (repro_torch.core.graph_loop); here five
                paths (SK tau-leap, CAL chromatic Gibbs, maxcut3r coloured
                Gibbs, SK CTMC, maxcut3r CTMC at beta = 3), each with and
                without first_hit, run graphed and through the private
                eager loop on the same seed (timeit, 300-500 steps):
                s, t, samples, times, energies, t_hit and hit identical,
                the launch counts equal (the graphed ones are the launches
                the replays ran), per-step walls of both.
     ctmc_dense — CTMC (tree draw, unroll "auto" = 2) on SK n=2048, 256
                chains x 20000 events, geometric(0.3, 3.0), first_hit =
                -0.70 n, 20 samples: chain-events/s, hit fraction; the
                incremental energy of the final states within 5e-3 + 1e-4
                |E| of problem.energy; then the same run on the event
                kernel (backend="cuda", csrc/ctmc_event.cu): one
                launch.ctmc_event an event, and s, t, samples, times,
                energies, hit and t_hit equal to the plain backend's.
     check_ctmc_event — the event kernel against its plain version
                (ref.ctmc_event_ref) at (256, 2000) over 1000 events, per-row
                betas, and at (7, 100) at lambda0 = 0.5 and (3, 2001) (rows
                of no 16-byte quads): s, h, e and t bit for bit;
     timing_ctmc_event — its CUDA-event median at (256, 2000) beside its
                bound and the plain event's time.
     ctmc_sparse — CTMC on maxcut3r n=16384 at a constant beta = 3.0, so
                run() carries the tree and repairs it in place (no O(n)
                build an event; asserted from the final state), 256 x 20000
                events: the same energy gate; the carried tree's leaves
                within 1e-5 (relative) of the rates of the final s and h,
                its root within 1e-3 (relative) of a fresh build of those
                rates.
     random_scan — RandomScanGibbs on SK, 256 x 20000 steps: the energy gate.
     fidelity — a 5-spin dense problem through the graph, 256 chains x 2000
                steps: random-scan empirical and CTMC time-weighted
                distributions within TV 0.03 of exact enumeration.
     diagnostics — run(diagnostics=True) on the CAL path: every sampled value
                equal to the run without it, flips > 0.
  7. faults   — the full-width main paths (SK n=2048 TauLeap and CAL
                ChromaticGibbs and maxcut3r n=16384 ColoredGibbs on the cuda
                backend; the SK and maxcut3r CTMC; random scan on SK; 256
                chains, CAL 4096; 200 steps) under FaultModel(5% stuck sites
                from make_stuck, quantize_bits=4, field_noise_std=0.1,
                dropout=0.1), the middle of benchmarks/robustness.py's grid:
                graphed against the private eager loop identical (s, t,
                samples, times, energies, t_hit, hit, launch counts); the
                three kernels' launches all fault variants (tau_leap_step_
                faults, lattice_gibbs_sweep_faults, colored_gibbs_sweep_faults:
                2 x 200, none of the base kernels), and all base launches
                without faults; FaultModel() identical to faults=None, launch
                counts included; stuck sites never leave their values;
                dropout=1.0 freezes the state (the CTMC's model time still
                advances); graphed µs a step with and without faults.
     apps     — Boltzmann CD: 3 cd_steps on a noisy 16x16 digit batch at the
                JAX default CDConfig (the 'pass' sampler: lattice tau-leap,
                plain torch on the card, no launch) and with
                sampler='chromatic' (every sweep through the lattice plan
                kernel: 3 x 64 launches); reconstruct of the digit with its top
                half clamped (kept exactly); parallel tempering on SK n=2048,
                8 rounds at benchmarks/figures.py's ladder (0.3, 0.6, 1.0,
                1.8), the replicas' energies those of their states; and
                decision.simulate at its default DecisionConfig (220 outer
                steps, one run() each); walls, swaps, arrival.
  Since slice 8 the checks also hold the three fault variants:
     check_faults_kernels — each variant against its plain version with
                random per-row biases b + eta and keep masks: tau_leap_step
                at the dense check shapes (dropped sites' uniforms warped to
                1.0, as TauLeap passes them), the lattice sweep at the
                lattice shapes through both kernels where check_lattice
                takes both, the coloured sweep at the sparse cases: spins
                equal outside the band of the base checks, kept sites equal
                to the input, frozen sites at their clamp, each call counted
                as its variant and not as the base kernel;
     timing_faults — each variant at its base kernel's timing shape with a
                bias on every row and dropout 0.1, beside its plain version
                and its bound.
  The long-row colour sweep (rows of n > 116224 sites, csrc/
  colored_gibbs_long.cu):
     check_long_sweep — three chained sweeps against the plain version bit
                for bit, per-row beta, at (64, 512000) on the 3D +-J EA
                lattice at L = 80 (two parity classes, degree 6), at
                (16, 131072) on random_3regular_maxcut's greedy colouring,
                and ragged at (5, 116230) on such a graph with its tables
                padded to 8 slots, each call counted as
                colored_gibbs_sweep_long;
     long_sweep_run — run(ColoredGibbs(), backend="cuda") at L = 80, 64
                chains, 60 sweeps at beta 1.4285714, 3 samples, graphed,
                equal to the plain backend on the card (s, samples,
                energies), 60 long-row launches;
     timing_long_sweep — its CUDA-event median at (64, 512000) beside its
                bound, its sector floor, its plain version and the
                uniforms' draw.
  The sparse energy (csrc/sparse_energy.cu: run()'s first-hit and recorded
  energy under ColoredGibbs(backend="cuda")):
     check_sparse_energy — both routes, each call counted as its route:
                the staged kernel (n <= 58112) on the 3-regular graphs of
                check_sparse, (4, 3, 4096) samples and a ring at
                n = 58112, the long-row pair on the EA lattice at
                (320, 512000) and (64, 5, 125000), a ring at n = 58113 and
                the ragged (5, 116230) graph with 8 slots: on every case,
                Gaussian couplings, biases and states included, bit for bit
                against its order of summation emulated in plain torch
                (sparse_gather.energy_in_kernel_order); against
                ref.sparse_energy_ref bit for bit on +-1 states with +-1
                couplings, and otherwise within ENERGY_EPS * n *
                (0.5 sum|s h| + sum|b s|) + ENERGY_EPS |E|;
     sparse_energy_run — graphed run(ColoredGibbs(), backend="cuda") with
                first_hit on maxcut3r n = 16384 and on the L = 50 lattice
                against the plain backend on the card (s, samples,
                energies, hit, t_hit), the energy launches counted;
     timing_sparse_energy — both routes' CUDA-event medians at (256,
                16384), D = 3 and (320, 512000), D = 6, beside their bounds
                and the plain version.
  Disorder samples (per-sample couplings (S, n, D) over one neighbour
  table, the rows sample-major):
     check_samples_sweep — the per-sample sweep (colored_gibbs_samples_kernel)
                against its plain version bit for bit, three chained sweeps
                with per-row beta, at ea3d32.samples' (512, 32768), 128
                samples of the L = 32 lattice (plan rows of 8), on a
                3-regular graph of 4096 sites with 3 samples of Gaussian
                couplings (packed rows of 4) and on a dense 40-site graph
                with 2 (rows of more than 8), each call counted as the
                per-sample route;
     check_samples_energy — the per-sample energy (sparse_energy_samples)
                on the swept states, on (B, 3, n) samples and on Gaussian
                states: bit for bit against its order of summation in plain
                torch; against the plain version bit for bit on +-1 states
                with +-1 couplings, and otherwise within energy_band's
                ENERGY_EPS bound, as check_sparse_energy;
     samples_run — the graphed run() at L = 32, 128 samples x 4 replicas,
                60 sweeps, 3 samples, against the plain backend on the card
                and, with 128 identical samples, against the one-table
                problem; 60 sweep and 2 energy launches;
     timing_samples — both kernels' CUDA-event medians at (512, 32768),
                S = 128, beside their bounds, their plain versions, the
                one-table sweep at the same rows and the uniforms' draw.
  The lattice energy (csrc/lattice_energy.cu: run()'s first-hit, start and
  recorded energy under ChromaticGibbs(backend="cuda")):
     check_lattice_energy — at (4096, 16, 16), (40960, 16, 16), (65, 8, 8)
                (the quad route), (3, 7, 13) and (1, 200, 200) (a block a
                chain), each call one launch: on +-1 states with CAL's
                couplings (+-1 couplings off 16x16) bit for bit against
                ref.lattice_energy_ref, and on Gaussian weights, biases and
                states within lattice_energy_band's ENERGY_EPS bound; on
                every case bit for bit against its order of summation
                emulated in plain torch (lattice_gibbs.energy_in_kernel_order);
     lattice_energy_run — graphed first-hit run(ChromaticGibbs(),
                backend="cuda") on CAL, 512 chains x 200 sweeps, against the
                plain backend on the card (s, samples, energies, hit, t_hit),
                1 + 200 + 1 energy launches; the CAL main path, the
                clamped conditional, the lattice stats, graph_vs_eager,
                diagnostics, faults and CD's chromatic sampler assert the
                energy's launches too (energy_launches);
     timing_lattice_energy — its CUDA-event medians at (4096, 16, 16) and
                the samples' (40960, 16, 16) beside their bounds and
                LatticeIsing.energy's plain torch.

  8. serve    — the serving stack at full width, random weights from seed 0:
                phi4-mini-3p8b (8 requests), gemma-2b, olmoe-1b-7b (4 each),
                recurrentgemma-9b (4; since slice 10) and xlstm-125m (8)
                through repro_torch.launch.serve.main with --no-reduced and
                launch/serve.py's other defaults (4 slots, 12 new tokens,
                max_len 128, temperature 0.7), internvl2-2b (4) through
                launch.serve.serve with N(0, 0.02) image patches (256, 2048)
                a request and max_len 384, and whisper-medium (4; since
                slice 11) through launch.serve.serve with N(0, 0.02) frames
                (1500, 1024) a request (main submits none, as the JAX
                driver does, so it cannot serve whisper): exactly one bf16
                flash launch per attention layer and request (the prefill
                attention; decode launches none; xlstm none at all), and
                for whisper also one per encoder layer and one per
                cross-attention, both bounded to the 1500 frames (kv_len):
                72 a request; every completion 12
                tokens, every logit finite; then, on each config with an
                attention layer, a greedy run with the kernel held against
                one with the plain attention on the same weights and
                prompts: each request's last-position prefill
                logits within SERVE_LOGITS_RTOL (relative L2), the tokens
                equal wherever the plain top-1 minus top-2 margin exceeds
                SERVE_MARGIN times the logits row's RMS (both fixed by the
                calibrations below; the other positions counted), some token
                held on every family but moe; recurrentgemma-9b's long
                request (a 2100-token prompt at max_len 2176: the ring
                branch, 12 banded launches at window 2048) held the same
                way; the kernel at each model's serving prefill shape
                (heads, 128 or 384, d), at the long request's banded
                one (16, 2176, 256, window 2048), and at whisper-medium's
                encoder and cross shapes with kv_len 1500, against its plain version
                as check_flash holds bf16; weight bytes, peak memory, prefill ms per request,
                decode ms per step, tokens/s, the decode step's bound (the
                bytes it reads and writes over HBM; an encoder-decoder's
                decode reads neither the encoder nor the cross wk and wv);
                the flash kernel at (24, 128, 128) beside its plain version
                and SDPA.
  9. train    — the training stack (slice 12), which launches no kernel:
                the JAX training forward attends through plain attention,
                and the flash kernel has no backward (its wrapper refuses
                autograd). full_width: launch.train.train on gemma-2b's full
                config in bf16, 10 steps of batch 4 x 1024 tokens (dense
                attention), the driver's lr and schedule, no checkpoint:
                every loss and grad norm finite, the last loss at least
                TRAIN_LOSS_DROP below the first, no kernel launched; ms a
                step (median after the first), tokens/s, peak memory, the
                state's bytes and the step's bound (6 N tokens at 989
                TFLOP/s plus 22 bytes a parameter over 3.35 TB/s).
                card_vs_cpu: each family's reduced config (gemma-2b,
                olmoe-1b-7b with the boltzmann router, internvl2-2b with
                patches, recurrentgemma-9b, xlstm-125m, whisper-medium with
                frames), float32, two make_train_step steps on the card and
                on the CPU from the same weights, batches and Gumbel draws:
                the losses, grad norms and the params after step 2 within
                TRAIN_CARD_RTOL (relative). resume: xlstm-125m at full width
                through launch.train.main, 6 steps saving at 3 and 6, then a
                fresh run from step 3 alone, under torch's deterministic
                algorithms (CUBLAS_WORKSPACE_CONFIG is set at the start):
                the recovery line, and every leaf of the two step-6
                checkpoints equal bit for bit. serve_restored:
                launch.serve.main --ckpt-dir on that directory serves
                exactly what the trained params serve, and not what the
                random init serves.
 10. shard    — the scale-out stack (slice 13), which launches no kernel.
                mesh_1x1: torch.distributed over NCCL with one rank (a file
                store in a temporary directory), launch.mesh.make_test_mesh
                ((1, 1)) on the card, and the train phase's full-width run
                (gemma-2b, 10 steps of 4 x 1024 tokens) through
                launch.train.train(..., mesh=mesh) under the tp_sp and then
                the fsdp_pure rules of launch.specs.rules_for (every tensor
                a DTensor): the ten losses within TRAIN_CARD_RTOL of the
                unsharded run's (and whether they are bit-equal), the median
                ms a step and its ratio to the unsharded step, peak memory.
                gloo_2x2: 4 gloo processes on the host's
                CPU, a 2x2 mesh, two train steps through launch.train.train
                of reduced gemma-2b under each rule set, of reduced
                qwen2-moe-a2p7b with 3 experts (TP on their FFN width) and
                of reduced recurrentgemma-9b (SHARD_GLOO), each against the
                unsharded driver from the same seed: losses, grad norms and
                every parameter within SHARD_GLOO["rtol"] (relative).
                dryrun: launch.dryrun.sweep of the SHARD_DRYRUN cells,
                each in a child process (a fake world of 256 ranks cannot
                share a process with NCCL), as many at once as the host has
                cores, artifacts in a temporary directory: every record `ok` on the host's torch, with its
                roofline line (modelled at the H100's data-sheet rates, not
                measured). added_wall: the two parts' seconds.
 11. examples — each ported example (repro_torch.examples: quickstart,
                optimization_cal, boltzmann_mnist --steps 5,
                neural_decision, serve_lm, train_lm into a fresh checkpoint
                directory) through its main once on the
                card: its headlines held to the bounds its CPU test holds
                (example_misses), wall and kernel launches (the examples
                take the samplers' default ref backends, as the JAX scripts
                do, so none are expected).

    python3 chip_smoke.py --card-serve-gates [arch ...]  # (~40 s on the card) and
    python3 chip_smoke.py --cpu-serve-gates [arch ...]   # (no card; several minutes)
                the serve gates' calibration: each serve config with an
                attention layer, in bf16, at full width on the card, at full
                depth and narrowed on the CPU, its greedy run with the plain
                attention (and recurrentgemma-9b's long request) held
                against the same with every attention output moved by up to
                one bf16 ulp, with a thousandth of them moved by one ulp, and
                with the heads' outputs rolled by one (a wrong head map);
                whisper-medium's encoder and cross-attention outputs too.
                Named archs only, if any are given.
    python3 chip_smoke.py --card-train-gates  # (~100 s on the card)
                the train phase's calibration: the same runs, every number
                its gates read printed, none held.

The last two lines are the kernels summary (the six kernels, the band and
the key-length bound of flash_attention as rows of their own, and the four
fault variants, with the
script's elapsed seconds, the build included) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores

CHECK_SHAPES = [(1, 5), (8, 64), (3, 130), (64, 300), (256, 2048), (3, 4099)]
TIME_SHAPE = (256, 2048)
P_BAND = 1e-6  # spins may differ only where the uniform is this close to p


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float, ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work on one H100 and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, n: int = 100, warmup: int = 10) -> float:
    """Median CUDA-event time of one call of `fn` over n calls.

    A sleep kernel queued first keeps the device behind the host, so every
    event pair brackets device work only, not host enqueue time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for i in range(n):
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# -- chromatic Gibbs (slice 2) -------------------------------------------------

LATTICE_SHAPES = [(1, 1, 1), (8, 8, 8), (4, 16, 16), (2, 32, 24), (3, 17, 23),
                  (16, 128, 128), (4096, 16, 16), (1, 200, 200)]
GENERIC_SHAPE = (8, 8, 8)  # check_lattice's random masks: the generic kernel's timing
# the shapes only the generic kernel takes: the random masks, and king lists
# longer than a block's threads
GENERIC_ONLY = (GENERIC_SHAPE, (16, 128, 128), (1, 200, 200))
# (B, n, graph): "dense" random couplings at a density, or a 3-regular MaxCut
SPARSE_CASES = [(1, 5, "dense", 1.0), (8, 100, "dense", 0.4), (3, 130, "dense", 0.05),
                (256, 16384, "3regular", 0), (2, 40000, "3regular", 1),
                (2, 65536, "3regular", 2),  # n > 58112: sparse_fields_global
                (298, 4096, "3regular", 3)]  # 3 staged rows a block, the last block 1
FIELD_EPS = 2.0**-22  # |dh_i| <= FIELD_EPS * (sum_k |w_ik| + |b_i|)
LATTICE_MAIN = dict(n_chains=4096, n_sweeps=500, sample_every=50)
SPARSE_MAIN = dict(n=16384, n_chains=256, n_sweeps=1000, sample_every=100)
CAL_HIT_MIN, CAL_HIT_GAP = 0.5, 0.05
CUT_MIN, CUT_REL_GAP = 0.85, 0.01
TV_GIBBS_MAX = 0.03  # the JAX bound, tests/test_core_samplers.py
# The exact CTMC and the sync baseline at full width: SK n=2048 and maxcut3r
# n=16384, 256 chains; the sparse run at a constant beta (the incremental tree).
CTMC_MAIN = dict(n_chains=256, n_events=20000, sparse_beta=3.0)
CTMC_SAMPLE_EVERY = 1000  # the dense runs' records: 20 samples
# the event kernel's checks, (B, n, events, lambda0), and its timing shape
# (sk2000.ctmc's: the K2000 size)
CTMC_EVENT_CASES = [(256, 2000, 1000, 1.0), (7, 100, 1000, 0.5), (3, 2001, 200, 1.0)]
CTMC_EVENT_SHAPE = (256, 2000)
# |e - E(s)| <= ENERGY_ATOL + ENERGY_RTOL |E|: the JAX bound at n=16
# (tests/test_sampler_api.py:276-283), plus f32 rounding of 20000 adds at |E| ~ 1400
ENERGY_ATOL, ENERGY_RTOL = 5e-3, 1e-4
# the sparse CTMC's carried tree: leaves against the rates of the final s and
# h, each relative to its rate; the root against a fresh build of those rates
TREE_LEAF_RTOL, TREE_ROOT_RTOL = 1e-5, 1e-3
FIDELITY = dict(n_chains=256, n_steps=2000, burn_in=20)  # 5 spins, sample_every=1
# |beta| of the bf16 field probe's copies: each resolves the fields with
# 2 <= beta |h| <= 40 or so, so together 2^-20 < |h| < 40; both signs put
# every p_up where bf16 uniforms are fine (near 0, not near 1).
PROBE_BETAS = tuple(sign * 16.0**k for k in range(6) for sign in (1.0, -1.0))

# -- attention (slice 3) --------------------------------------------------------

BF16_OPS_PER_S = 989e12  # dense, tensor cores
# (BH, Sq, Sk, d, causal, dtype)
FLASH_CASES = [(2, 256, 256, 64, True, "float32"), (4, 128, 384, 32, False, "float32"),
               (1, 512, 512, 128, True, "bfloat16"), (2, 256, 256, 64, True, "bfloat16"),
               (2, 256, 128, 64, True, "float32"), (2, 128, 384, 64, True, "bfloat16"),
               (1, 256, 256, 256, True, "float32"),
               # main_attention's shapes in f32: its bf16 runs are checked there
               (24, 4096, 4096, 128, True, "float32"), (8, 4096, 4096, 256, True, "float32"),
               # head dims that fill no whole 64-column group
               (3, 128, 256, 8, True, "float32"), (2, 128, 128, 40, False, "float32"),
               (1, 256, 128, 136, True, "bfloat16"),
               # the bf16 kernel at the JAX grid's f32 shape and at d = 8
               (4, 128, 384, 32, False, "bfloat16"), (3, 128, 256, 8, True, "bfloat16")]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the JAX test's, tests/test_kernels.py
BF16_ULP = 2.0**-7  # one bf16 ulp, relative to |o|, with 1e-6 absolute near 0
# Prefill attention at train_4k (configs/base.py), batch 1: (config, query
# heads, KV heads, head dim), from src/repro/configs/{phi4_mini_3p8b,gemma_2b}.py
ATTENTION_MAIN = [("phi4-mini-3.8B", 24, 8, 128), ("gemma-2b", 8, 1, 256)]
ATTENTION_S = 4096
# The sliding-window band (slice 10), (BH, S, d, window), causal, in f32 and
# bf16: recurrentgemma-9b's attn_local prefill (16 query heads over 1 KV head,
# d = 256, window 2048) at S = 4096, timed there; and a window that is no
# multiple of 128 across the tiles of a small shape.
FLASH_WINDOW_CASES = [(16, 4096, 256, 2048), (4, 512, 64, 200)]
# The key-length bound (slice 11), (BH, Sq, Sk, d, kv_len), non-causal, in f32
# and bf16: whisper-medium's encoder (16 heads of 64 over its 1500 frames,
# padded to 1536) and its cross-attention's prefill (a prompt padded to 128
# queries over those keys), timed at the first; a bound mid-tile; one at a
# tile's edge.
FLASH_KV_LEN_CASES = [(16, 1536, 1536, 64, 1500), (16, 128, 1536, 64, 1500),
                      (4, 128, 384, 32, 200), (2, 256, 512, 64, 384)]

# -- the redesigned kernels (slice 4) ---------------------------------------------

SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "IMMA", "LDG", "LDS")
SASS_LIBS = ("flash_attention", "tau_leap", "dense_field", "sparse_fields", "colored_gibbs",
             "colored_gibbs_long", "sparse_energy", "lattice_gibbs", "lattice_energy",
             "ctmc_event")
# each kernel's name in the libraries' SASS, and the instructions it must hold
SASS_KERNELS = {"flash_bf16_kernel": ("HGMMA", "UTMALDG"), "flash_f32_kernel": (),
                "tau_leap_kernel": ("LDGSTS", "IMMA"), "pack_spins_kernel": (),
                "dense_field_kernel": ("LDGSTS", "IMMA"),
                "sparse_fields_staged": ("LDS",), "sparse_fields_global": (),
                "colored_gibbs_kernel": ("LDS",), "colored_gibbs_samples_kernel": ("LDS",),
                "colored_gibbs_long_pack": (),
                "colored_gibbs_long_phase": (), "colored_gibbs_long_unpack": (),
                "sparse_energy_rows": ("LDS",), "sparse_energy_tile": ("LDS",),
                "sparse_energy_sum": (), "sparse_energy_samples": (),
                "ctmc_event_kernel": ("LDS",),
                "lattice_gibbs_plan": ("LDS",),
                "lattice_gibbs_generic": ("LDS",),
                "lattice_energy_quads": ("LDS",), "lattice_energy_block": ()}
# the 64 x 65536-site rows sparse_fields_global is timed on: as many
# outputs as the main path's (256, 16384)
GLOBAL_FIELDS_SHAPE = (64, 65536)


# every kernel route the wrappers count, `launch.<name>` in tracing.counts()
LAUNCHED = ("tau_leap_step", "dense_field", "tau_leap_step_faults",
            "lattice_gibbs_sweep", "lattice_gibbs_generic", "lattice_energy", "sparse_fields",
            "sparse_fields_global", "colored_gibbs_sweep", "colored_gibbs_sweep_long",
            "sparse_energy", "sparse_energy_long", "colored_gibbs_sweep_samples",
            "sparse_energy_samples", "lattice_gibbs_sweep_faults",
            "lattice_gibbs_generic_faults", "colored_gibbs_sweep_faults", "flash_attention",
            "flash_attention_window", "flash_attention_kv_len", "flash_attention_bf16",
            "flash_attention_f32", "ctmc_event")


def counters():
    """(reset, read): `reset` takes a snapshot of `tracing.counts()`, `read`
    returns each kernel's launches since, by the names of LAUNCHED."""
    from repro_torch import tracing

    since = tracing.counts()

    def reset():
        nonlocal since
        since = tracing.counts()

    def read():
        now = tracing.counts()
        return {k: now[f"launch.{k}"] - since[f"launch.{k}"] for k in LAUNCHED}

    return reset, read


def check_attention(torch, ops, what, out, q, k, v, causal, window=0, kv_len=None):
    """Hold a flash_attention output (banded with `window` > 0, its keys
    bounded by `kv_len`) against its plain version: within FLASH_TOL in q's dtype, and in bf16 also within
    one bf16 ulp of the plain version's f32 result, since both round f32
    values of the same sums (outputs of ~0.01 at S = 4096 would pass 2e-2
    with a key tile dropped). Returns (max |err|, max |err| / one ulp; 0 in
    f32)."""
    plain = ops.flash_attention(q, k, v, causal, mode="reference", window=window, kv_len=kv_len)
    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    e = (out.float() - plain.float()).abs()
    n_bad = int((e > tol + tol * plain.float().abs()).sum())
    ulps = 0.0
    if q.dtype == torch.bfloat16:
        exact = ops.flash_attention(q.float(), k.float(), v.float(), causal, mode="reference",
                                    window=window, kv_len=kv_len)
        ulps = float(((out.float() - exact).abs() / (BF16_ULP * exact.abs() + 1e-6)).max())
    finite = bool(torch.isfinite(out).all())
    if out.dtype != q.dtype or out.shape != q.shape or not finite or n_bad or ulps > 1.0:
        raise AssertionError(f"flash_attention {what}: {out.dtype} {tuple(out.shape)}, finite "
                             f"{finite}, {n_bad} elements off by more than {tol} (abs and rel), "
                             f"{ulps} bf16 ulps from the f32 plain version")
    return float(e.max()), ulps


def kernel_name(mangled: str) -> str:
    """A kernel's SASS_KERNELS name and, for a template, its float, bf16,
    integer and bool arguments (flash_bf16_kernel<128>,
    colored_gibbs_kernel<1>, lattice_gibbs_plan<bf16>)."""
    import re

    name = next((k for k in SASS_KERNELS if k in mangled), mangled)
    args = re.search(r"I((?:f|13__nv_bfloat16|L[ib]\d+E)+)E", mangled)
    if args:
        name += "<" + ",".join(
            "f32" if m.group(1) else "bf16" if m.group(2) else m.group(3)
            for m in re.finditer(r"(f)|(13__nv_bfloat16)|L[ib](\d+)E", args.group(1))) + ">"
    return name


def sass_counts(build_dir, cuobjdump) -> dict:
    """{library: {kernel: {op: count}}} from cuobjdump -sass of each library
    in SASS_LIBS, each kernel under its `kernel_name`."""
    import re

    out = {}
    for lib in SASS_LIBS:
        sass = subprocess.run([str(cuobjdump), "-sass", str(build_dir / f"lib{lib}.so")],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        out[lib] = {kernel_name(chunk.split("\n", 1)[0].strip()):
                    {op: len(re.findall(rf"\b{op}\b", chunk)) for op in SASS_OPS}
                    for chunk in sass.split("Function : ")[1:]}
    return out


def ptxas_by_kernel(log: str) -> dict:
    """{kernel: [ptxas's spill line, its registers line]} from a -Xptxas -v log."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def phase_band(torch, fields, s, u, masks, frozen, beta, tol):
    """Sites where some phase of the plain sweep drew a uniform within `tol`
    of its p_up: the only sites where kernel and plain spins may differ."""
    band = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    b = beta.reshape((-1,) + (1,) * (s.ndim - 1))
    for c in range(masks.shape[0]):
        p = torch.sigmoid(-2.0 * (b * fields(s)))
        upd = masks[c] & ~frozen
        band |= upd & ((u[c] - p).abs() <= tol)
        s = torch.where(upd, torch.where(u[c] < p, 1.0, -1.0).to(s.dtype), s)
    return band


def bf16_bracket(torch, p):
    """(lo, hi) in bf16 for f32 p > 0: the largest bf16 below p and the
    smallest bf16 at or above it."""
    bits = p.view(torch.int32)
    t = bits & -0x10000  # p rounded toward zero to bf16
    exact = t == bits
    lo = torch.where(exact, t - 0x10000, t).view(torch.float32)
    hi = torch.where(exact, t, t + 0x10000).view(torch.float32)
    return lo.to(torch.bfloat16), hi.to(torch.bfloat16)


def bf16_field_probe(torch, sweep, s, w, b, frozen, clampv, masks):
    """The bf16 sweep's fields probed through p_up, one phase a mask of
    `masks` (each (1, H, W); together they hold every site) updating its
    free sites of len(PROBE_BETAS) copies of the chains, copy k at beta =
    PROBE_BETAS[k]: uniforms at `hi` (the smallest bf16 >= the plain p_up)
    give -1 and at `lo` (the largest bf16 below it) +1 unless the kernel's
    p_up leaves (lo, hi]. Where p_up at both bf16 neighbours of the plain
    field h also lies outside (lo, hi], a kernel field other than h would
    show: the site is resolved; a field of exactly 0 never is (p_up = 0.5 at
    every beta). Returns (sites whose kernel p_up left the bracket, free
    sites resolved in some copy, free sites, free sites with h = 0)."""
    from repro_torch.kernels import ref

    B, H, W = s.shape
    n = len(PROBE_BETAS)
    beta = torch.tensor(PROBE_BETAS, device=s.device).repeat_interleave(B)

    def p_up(h):  # as the kernel forms it
        x = -2.0 * (beta[:, None, None] * h)
        return 1.0 / (1.0 + torch.exp(-x))

    h = ref.lattice_fields_ref(s, w, b).float().repeat(n, 1, 1)
    p = p_up(h)
    valid = p > 0  # p_up underflowed to 0: no uniform below it
    lo, hi = bf16_bracket(torch, torch.where(valid, p, 1.0))
    # the bf16 values next to h: one bf16 ulp up and down (bit steps of
    # 0x10000 in the f32 pattern, signed by h); +-the least bf16 around 0
    bits = h.view(torch.int32)
    step = torch.where(h >= 0, 1, -1).to(torch.int32) * 0x10000
    up = torch.where(h == 0, 0x10000, bits + step).view(torch.float32)
    down = torch.where(h == 0, -0x7FFF0000, bits - step).view(torch.float32)
    lo_f, hi_f = lo.float(), hi.float()
    resolved = valid
    for q in (p_up(up), p_up(down)):
        resolved = resolved & ~((lo_f < q) & (q <= hi_f))
    s_n = s.repeat(n, 1, 1)
    free = ~(frozen > 0.5)
    n_field = 0
    for m in masks:  # one phase each; together they probe every free site once
        out_hi = sweep(s_n, w, b, hi[None].contiguous(), m, frozen, clampv, beta)
        out_lo = sweep(s_n, w, b, lo[None].contiguous(), m, frozen, clampv, beta)
        probed = free & (m[0] > 0.5)
        n_field += int((((out_hi != -1.0) | (out_lo != 1.0)) & valid & probed).sum())
    n_resolved = int((resolved.reshape(n, B, H, W).any(0) & free).sum())
    n_zero = int(((h[:B] == 0) & free).sum())
    return n_field, n_resolved, int(free.sum()) * B, n_zero


def lattice_sector_floor_ms(torch, plan, B, itemsize):
    """The lattice sweep's sector floor (ms): the uniforms a phase reads lie
    spread over its (B, H, W) plane, so in the (C, B, H, W) layout they cost
    every 32-byte sector they touch; plus s, the new s, the plan and beta."""
    H, W = plan.shape
    rows = torch.arange(B, device=plan.entry.device)[:, None] * (H * W)
    offsets = plan.offsets.tolist()
    sectors = sum(int(torch.unique((rows + plan.sites[a:z].long()[None]) // (32 // itemsize))
                      .numel()) for a, z in zip(offsets[:-1], offsets[1:]))
    plan_bytes = sum(x.numel() * x.element_size() for x in plan[:5])
    return (2 * B * H * W * itemsize + 32 * sectors + plan_bytes + 4 * B) / HBM_BYTES_PER_S * 1e3


def lattice_host_us(lattice_gibbs, args, plan, n: int = 1000, rounds: int = 5) -> dict:
    """Host µs per call of the lattice wrapper on these operands and plan:
    the whole wrapper with its launch replaced by nothing (its launch count
    put back after), and check_plan alone. Median of `rounds` rounds of n
    calls on the host clock."""
    def per_call(fn):
        walls = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            walls.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(walls)

    from repro_torch import tracing

    name, real = "launch.lattice_gibbs_sweep", lattice_gibbs._launch_plan
    count = tracing.counts()[name]
    lattice_gibbs._launch_plan = lambda *a: None
    try:
        wrapper = per_call(lambda: lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan))
    finally:
        lattice_gibbs._launch_plan = real
        tracing.count(name, count - tracing.counts()[name])
    w, b, _, colors, frozen, clampv, _ = args[1:]
    return {"wrapper_without_launch": wrapper,
            "check_plan": per_call(lambda: lattice_gibbs.check_plan(plan, w, b, colors, frozen,
                                                                    clampv))}


# -- the device-fault model and the applications (slice 8) ---------------------

# The fault variants of the three run() kernels, by their launch-counter names
FAULT_VARIANTS = ("tau_leap_step_faults", "lattice_gibbs_sweep_faults",
                  "lattice_gibbs_generic_faults", "colored_gibbs_sweep_faults")
# The middle of benchmarks/robustness.py's fault grid: 5% stuck sites
# (make_stuck), 4-bit couplings, field noise 0.1, dropout 0.1.
FAULTS = dict(fraction=0.05, quantize_bits=4, field_noise_std=0.1, dropout=0.1)
FAULT_STEPS, FAULT_SAMPLE_EVERY = 200, 50
# the ladder of benchmarks/figures.py's parallel-tempering runs
TEMPERING = dict(betas=(0.3, 0.6, 1.0, 1.8), n_rounds=8, steps_per_round=8)
CD_STEPS = 3
DECISION_TARGETS = ((-300.0, 1000.0), (300.0, 1000.0))  # tests/test_ml_and_decision.py's

# -- the serving stack (slice 9) --------------------------------------------------

# (arch, requests): served at full width through launch.serve.main with the JAX
# entry point's other defaults (a vlm through launch.serve.serve, with image
# patches; whisper-medium the same way, with frames), then greedily with the kernel and with the plain attention on the
# same weights and prompts
SERVE_MODELS = (("phi4-mini-3p8b", 8), ("gemma-2b", 4), ("olmoe-1b-7b", 4),
                ("internvl2-2b", 4), ("recurrentgemma-9b", 4), ("xlstm-125m", 8),
                ("whisper-medium", 4))
SERVE_SLOTS, SERVE_MAX_NEW, SERVE_MAX_LEN = 4, 12, 128
SERVE_ARGS = ("--no-reduced", "--slots", str(SERVE_SLOTS), "--max-new", str(SERVE_MAX_NEW),
              "--max-len", str(SERVE_MAX_LEN), "--temperature", "0.7")
# a vlm's max_len: its 256 patches, a prompt of up to 15 tokens and 12 new
# ones (the JAX driver's 128 cannot hold the patches)
SERVE_VLM_MAX_LEN = 384
# the long request: a prompt past recurrentgemma's window of 2048, so its
# attn_local layers take the ring branch and the band (prompt, max_len)
SERVE_LONG = {"recurrentgemma-9b": (2100, 2176)}
# Relative L2 error of each request's last-position prefill logits, kernel
# against plain attention, by family: twice the largest `--cpu-serve-gates`
# saw with every attention output moved by up to one bf16 ulp (the kernel's
# own contract), and far below what a wrong head map gives there. At full width
# `--card-serve-gates` sees 0.025 / 0.022 / 0.084 (phi4-mini / gemma-2b /
# olmoe-1b-7b) within one ulp and 0.81-1.46 for a wrong head map. The vlm and
# hybrid gates likewise: within one ulp internvl2-2b 0.0211 (card) / 0.0215
# (CPU), recurrentgemma-9b 0.0293 / 0.0385 and its long request 0.0263 /
# 0.0366; a wrong head map 0.94-1.40 and 0.81-1.12, on the long request
# 0.12 / 0.20, still 1.5x the hybrid gate, which is why the long request's
# banded kernel is also held at its served shape. audio (whisper-medium, its
# encoder, self and cross attention all moved): 0.0140 (card) / 0.0134 (CPU);
# a wrong head map 1.38 / 1.34. The ssm family (xlstm) has
# no attention layer, so no greedy pair and no gate.
SERVE_LOGITS_RTOL = {"dense": 6e-2, "moe": 2.5e-1, "vlm": 5e-2, "hybrid": 8e-2, "audio": 3e-2}
# A greedy token is held to the plain run's where the plain top-1 minus top-2
# margin exceeds SERVE_MARGIN times that logits row's RMS, by family: twice the
# largest max |deviation| / RMS that `--card-serve-gates` (full width) or
# `--cpu-serve-gates` (narrowed) saw with the attention outputs moved within one
# bf16 ulp, every one or a thousandth of them (0.162 on phi4-mini on the card,
# 0.880 on the narrowed olmoe-1b-7b; a flip needs two deviations to sum past the
# margin). Fixed here, not taken from the run under test. Every family but moe
# must hold some token; on olmoe a flipped expert moves the logits so far that hardly
# any position clears its margin, so there the gate asserts only that no token
# flips above it. vlm: 0.113 (card) / 0.090 (CPU); hybrid: 0.147 / 0.156, the
# long request 0.134 / 0.146; audio: 0.0637 / 0.0641 (whisper-medium's random
# logits are near flat at the top: on the card its plain margins are 0 to 0.22
# RMS, in steps of one bf16 ulp, 0.024 RMS).
SERVE_MARGIN = {"dense": 0.33, "moe": 1.8, "vlm": 0.23, "hybrid": 0.32, "audio": 0.13}
# the calibration's configs: full depth and head dims, the grouping kept,
# narrowed to run on the CPU
SERVE_NARROW = {
    "phi4-mini-3p8b": dict(d_model=384, n_heads=3, n_kv_heads=1, d_ff=1024, vocab_size=8192),
    "gemma-2b": dict(d_model=512, n_heads=2, n_kv_heads=1, d_ff=2048, vocab_size=8192),
    "olmoe-1b-7b": dict(d_model=256, n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=8192),
    "internvl2-2b": dict(d_model=256, n_heads=2, n_kv_heads=1, d_ff=1024, vocab_size=8192),
    "recurrentgemma-9b": dict(d_model=512, n_heads=2, n_kv_heads=1, d_ff=1024,
                              vocab_size=8192, lru_width=512),
    # hd 64 and the 1500 frames kept
    "whisper-medium": dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=512, vocab_size=8192),
}


def _fault_inputs(torch, np, rng, shape, dev):
    """Per-row bias noise (0.3 randn) and a keep mask (0.8 kept) of `shape`."""
    eta = torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=dev)
    keep = torch.as_tensor(rng.random(shape) >= 0.2, device=dev)
    return eta, keep


def check_faults_kernels(torch, np, dev, read) -> tuple[dict, dict]:
    """Each fault variant against its plain version on the card, at the
    check shapes of its base kernel (the full-width ones included), with
    random per-row biases and keep masks: spins equal outside the band the
    base checks use, kept sites bit-equal to the input, frozen sites at
    their clamp, and each call counted as its variant and not as the base
    kernel. Returns ({variant: max |err| outside the band}, {variant:
    mismatches})."""
    from repro_torch.core import ising, problems
    from repro_torch.core.ising import king_color_masks
    from repro_torch.core.sparse import SparseIsing
    from repro_torch.kernels import lattice_gibbs, ops, ref, sparse_gather, tau_leap

    rng = np.random.default_rng(18)
    err, mism = dict.fromkeys(FAULT_VARIANTS, 0.0), dict.fromkeys(FAULT_VARIANTS, 0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def pm1(shape):
        return f32(rng.choice([-1.0, 1.0], shape))

    def counted(label, before, variant):
        delta = {k: v - before[k] for k, v in read().items()}
        if delta != dict(dict.fromkeys(delta, 0), **{variant: 1}):
            raise AssertionError(f"{label}: launched {delta}, expected one {variant}")

    def record(name, label, out_k, out_r, band, kept, s):
        differ = out_k != out_r
        bad = int((differ & ~band).sum())
        n_kept = int((out_k[kept] != s[kept]).sum())
        if bad or n_kept:
            raise AssertionError(f"{name} {label}: {bad} spins differ outside the band, "
                                 f"{n_kept} kept sites changed")
        mism[name] += int(differ.sum())
        err[name] = max(err[name], float(((out_k - out_r).abs() * ~band).max()))
        emit({"phase": "check_faults_kernels", "kernel": name, "shape": list(s.shape),
              "case": label, "mismatches": int(differ.sum()), "in_band": int(band.sum()),
              "kept_sites": int(kept.sum())})

    scale = torch.tensor(1.0 / 127.0, device=dev)
    dt = torch.tensor(0.3, device=dev)
    for B, N in CHECK_SHAPES:
        s = pm1((B, N))
        J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
        b = f32(rng.normal(0.0, 0.2, N))
        u = f32(rng.random((B, N)))
        beta = f32(rng.uniform(0.3, 3.0, B))
        eta, keep = _fault_inputs(torch, np, rng, (B, N), dev)
        rows = b + eta
        # dropped sites take u = 1.0, as TauLeap passes them: a flip needs u < p <= 1
        u_w = torch.where(keep, u, 1.0)
        before = read()
        out_k = tau_leap.tau_leap_step(s, J, rows, scale, u_w, dt, beta)
        counted(f"tau_leap_step_faults ({B},{N})", before, "tau_leap_step_faults")
        p = ref.tau_leap_flip_prob_ref(s, J, beta[:, None] * rows, (beta * scale)[:, None], dt)
        out_r = ops.tau_leap_step(s, J, b, scale, u_w, dt, beta=beta, mode="reference",
                                  bias_rows=rows)
        record("tau_leap_step_faults", "bias_rows", out_k, out_r, (u_w - p).abs() <= P_BAND,
               ~keep, s)

    for B, H, W in LATTICE_SHAPES:
        s = pm1((B, H, W))
        w = f32(rng.normal(0.0, 0.5, (8, H, W)))
        b = f32(rng.normal(0.0, 0.3, (H, W)))
        u = f32(rng.random((4, B, H, W)))
        colors_b = king_color_masks(H, W, device=dev)
        if (B, H, W) == (8, 8, 8):  # an improper colouring, as check_lattice
            colors_b = torch.as_tensor(rng.random((4, H, W)) < 0.5, device=dev)
        frozen_b = torch.as_tensor(rng.random((H, W)) < 0.2, device=dev)
        clampv = pm1((H, W))
        beta = f32(rng.uniform(0.3, 3.0, B))
        eta, keep = _fault_inputs(torch, np, rng, (B, H, W), dev)
        rows = b + eta
        colors, frozen = colors_b.float(), frozen_b.float()
        plan = lattice_gibbs.lattice_plan(w, b, colors, frozen, clampv)
        routes = [("lattice_gibbs_generic_faults", plan._replace(independent=False))]
        if plan.independent and plan.threads:
            routes.insert(0, ("lattice_gibbs_sweep_faults", plan))
        args = (s, w, b, u, colors, frozen, clampv, beta)
        out_r = ops.lattice_gibbs_sweep(*args, mode="reference", bias_rows=rows, keep=keep)
        band = phase_band(torch, lambda x: ref.lattice_fields_ref(x, w, rows), s, u,
                          colors_b[:, None] & keep, frozen_b, beta, P_BAND)
        for name, route_plan in routes:
            before = read()
            out_k = lattice_gibbs.lattice_gibbs_sweep(*args, plan=route_plan, bias_rows=rows,
                                                      keep=keep)
            counted(f"{name} ({B},{H},{W})", before, name)
            n_clamp = int((out_k[:, frozen_b] != clampv[frozen_b]).sum())
            if n_clamp:
                raise AssertionError(f"{name} ({B},{H},{W}): {n_clamp} frozen sites off clamp")
            record(name, "bias_rows+keep", out_k, out_r, band, ~keep & ~frozen_b, s)

    for B, n, graph, arg in SPARSE_CASES:
        if graph == "3regular":
            sp = problems.random_3regular_maxcut(n, arg, device=dev)
        else:
            A = rng.normal(0.0, 0.6, (n, n)) * (rng.random((n, n)) < arg)
            J = np.triu(A, 1)
            sp = SparseIsing.from_dense(ising.DenseIsing.from_numpy(
                J + J.T, rng.normal(0.0, 0.3, n), device=dev))
        idx, w, b = sp.nbr_idx, sp.nbr_w, sp.b
        s = pm1((B, n))
        masks_b = sp.color_masks
        C = masks_b.shape[0]
        u = f32(rng.random((C, B, n)))
        beta = f32(rng.uniform(0.3, 3.0, B))
        eta, keep = _fault_inputs(torch, np, rng, (B, n), dev)
        rows = b + eta
        before = read()
        out_k = sparse_gather.colored_gibbs_sweep(s, idx, w, b, u, masks_b.float(), beta,
                                                  bias_rows=rows, keep=keep)
        counted(f"colored_gibbs_sweep_faults ({B},{n})", before, "colored_gibbs_sweep_faults")
        out_r = ops.colored_gibbs_sweep(s, idx, w, b, u, masks_b.float(), beta,
                                        mode="reference", bias_rows=rows, keep=keep)
        fbound = FIELD_EPS * (w.abs().sum(-1) + rows.abs())
        band = phase_band(torch, lambda x: ref.sparse_fields_ref(x, idx, w, rows), s, u,
                          masks_b[:, None] & keep, torch.zeros(n, dtype=torch.bool, device=dev),
                          beta, beta[:, None] / 2 * fbound + P_BAND)
        record("colored_gibbs_sweep_faults", graph, out_k, out_r, band, ~keep, s)
    torch.cuda.synchronize()
    return err, mism


def time_fault_variants(torch, np, dev, ms, bounds) -> None:
    """Each fault variant at its base kernel's timing shape, with a bias
    (noise 0.1) and a keep mask (dropout 0.1) on every row: its CUDA-event
    median, its plain version's, and its bound (each input read once: of
    the uniforms, the biases and the neighbours only those of the sites a
    phase updates and does not drop; the keep bytes of the updated sites),
    into `ms` and `bounds`."""
    from repro_torch.core import problems
    from repro_torch.core.ising import king_color_masks
    from repro_torch.kernels import lattice_gibbs, ops, sparse_gather, tau_leap

    rng = np.random.default_rng(19)
    B, N = TIME_SHAPE
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
    J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
    b = torch.zeros(N, dtype=torch.float32, device=dev)
    rows = b + 0.1 * torch.randn((B, N), device=dev)
    u = torch.rand((B, N), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    scale, dt = torch.tensor(1.0 / 127.0, device=dev), torch.tensor(0.1, device=dev)
    ms["tau_leap_step_faults"] = time_ms(
        torch, lambda: tau_leap.tau_leap_step(s, J, rows, scale, u, dt, beta))
    ms["tau_leap_step_faults_plain"] = time_ms(torch, lambda: ops.tau_leap_step(
        s, J, b, scale, u, dt, beta=beta, mode="reference", bias_rows=rows))
    bounds["tau_leap_step_faults"] = bound(N * N + 4 * 4 * B * N + 4 * B + 8, 2.0 * B * N * N)

    def lattice(shape, masks_of, frozen_b, w, bias, clampv, plan_of, name):
        B, H, W = shape
        HW = H * W
        s = torch.where(torch.rand(shape, device=dev) < 0.5, 1.0, -1.0)
        u = torch.rand((4,) + shape, device=dev)
        beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
        colors, frozen = masks_of.float(), frozen_b.float()
        rows = bias + 0.1 * torch.randn(shape, device=dev)
        keep = torch.rand(shape, device=dev) >= 0.1
        plan = plan_of(lattice_gibbs.lattice_plan(w, bias, colors, frozen, clampv))
        args = (s, w, bias, u, colors, frozen, clampv, beta)
        ms[name] = time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
            *args, plan=plan, bias_rows=rows, keep=keep))
        ms[name + "_plain"] = time_ms(torch, lambda: ops.lattice_gibbs_sweep(
            *args, mode="reference", bias_rows=rows, keep=keep))
        upd = masks_of & ~frozen_b  # (C, H, W)
        updated = float(upd.sum())
        live = float((upd[:, None] & keep).sum())  # updated and not dropped, every row
        bounds[name] = bound(4 * (2 * B * HW + 8 * HW + HW + 4 * HW + 2 * HW + B)
                             + B * updated + 8 * live, live * 22, FP32_OPS_PER_S)

    cal = problems.cal_problem(device=dev)
    H, W = cal.shape
    lattice((LATTICE_MAIN["n_chains"], H, W), king_color_masks(H, W, device=dev),
            cal.frozen_mask, cal.w, cal.b, cal.frozen_values, lambda p: p,
            "lattice_gibbs_sweep_faults")
    Bg, Hg, Wg = GENERIC_SHAPE
    grng = np.random.default_rng(8)  # check_lattice's random masks, as the base entry
    lattice(GENERIC_SHAPE, torch.as_tensor(grng.random((4, Hg, Wg)) < 0.5, device=dev),
            torch.as_tensor(grng.random((Hg, Wg)) < 0.2, device=dev),
            torch.as_tensor(grng.normal(0.0, 0.5, (8, Hg, Wg)).astype(np.float32), device=dev),
            torch.as_tensor(grng.normal(0.0, 0.3, (Hg, Wg)).astype(np.float32), device=dev),
            torch.ones((Hg, Wg), device=dev), lambda p: p._replace(independent=False),
            "lattice_gibbs_generic_faults")

    mc = problems.random_3regular_maxcut(SPARSE_MAIN["n"], 0, device=dev)
    B, n, D = SPARSE_MAIN["n_chains"], mc.n, mc.max_deg
    masks = mc.color_masks.float()
    C = masks.shape[0]
    s = torch.where(torch.rand((B, n), device=dev) < 0.5, 1.0, -1.0)
    u = torch.rand((C, B, n), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    rows = mc.b + 0.1 * torch.randn((B, n), device=dev)
    keep = torch.rand((B, n), device=dev) >= 0.1
    plan = sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b, masks)
    args = (s, mc.nbr_idx, mc.nbr_w, mc.b, u, masks, beta)
    ms["colored_gibbs_sweep_faults"] = time_ms(torch, lambda: sparse_gather.colored_gibbs_sweep(
        *args, plan=plan, bias_rows=rows, keep=keep))
    ms["colored_gibbs_sweep_faults_plain"] = time_ms(torch, lambda: ops.colored_gibbs_sweep(
        *args, mode="reference", bias_rows=rows, keep=keep))
    updated = float(masks.sum())
    live = float((mc.color_masks[:, None] & keep).sum())
    bounds["colored_gibbs_sweep_faults"] = bound(
        4 * (2 * B * n + 2 * n * D + n + C * n + B) + B * updated + 8 * live,
        live * (2 * D + 6), FP32_OPS_PER_S)


def fault_paths(torch, dev, sk, cal, mc, targets, reset, read, smi) -> dict:
    """The full-width main paths under the FAULTS model (module docstring,
    phase `faults`); returns the graphed faulted runs' launch counts."""
    from repro_torch.core.faults import FaultModel, make_stuck
    from repro_torch.core.sampler_api import (CTMC, ChromaticGibbs, ColoredGibbs, TauLeap,
                                              _make_run, constant, geometric, run, state_shape)

    sched = geometric(0.3, 3.0)
    paths = (
        ("sk_tau_leap", sk, TauLeap(dt=0.1), "cuda", 256, sched, "tau_leap_step"),
        ("cal_chromatic", cal, ChromaticGibbs(), "cuda", LATTICE_MAIN["n_chains"], sched,
         "lattice_gibbs_sweep"),
        ("maxcut3r_colored", mc, ColoredGibbs(), "cuda", 256, sched, "colored_gibbs_sweep"),
        ("sk_ctmc", sk, CTMC(), None, 256, sched, None),
        ("maxcut3r_ctmc", mc, CTMC(), None, 256, constant(3.0), None),
        ("sk_random_scan", sk, "random_scan_gibbs", None, 256, sched, None),
    )
    fields = ("s", "t", "samples", "times", "energies", "t_hit", "hit")
    zero = dict.fromkeys(read(), 0)
    out, launches = {}, {}
    for name, problem, kernel, backend, chains, schedule, kname in paths:
        mask, values = make_stuck(torch.Generator(device=dev).manual_seed(18), problem,
                                  FAULTS["fraction"])
        faults = FaultModel(stuck_mask=mask, stuck_values=values,
                            **{k: v for k, v in FAULTS.items() if k != "fraction"})
        runs = {}
        for mode, fm, eager in (("faults", faults, False), ("faults_eager", faults, True),
                                ("clean", None, False), ("noop", FaultModel(), False)):
            reset()
            make = _make_run(problem, kernel, 5, n_steps=FAULT_STEPS, n_chains=chains,
                             sample_every=FAULT_SAMPLE_EVERY, schedule=schedule,
                             first_hit=targets[name], backend=backend, faults=fm, eager=eager)
            walls = []
            for _ in range(2):  # a first pass (captures), then the timed one
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = make()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            runs[mode] = (res, read(), walls[1])
        (f_res, f_l, f_wall), (e_res, e_l, e_wall) = runs["faults"], runs["faults_eager"]
        (c_res, c_l, c_wall), (n_res, n_l, _) = runs["clean"], runs["noop"]
        for label, (a, la), (b, lb) in (("graph against eager under faults", (f_res, f_l),
                                         (e_res, e_l)),
                                        ("FaultModel() against faults=None", (n_res, n_l),
                                         (c_res, c_l))):
            differ = [f for f in fields if not torch.equal(getattr(a, f), getattr(b, f))]
            if differ or la != lb:
                raise AssertionError(f"faults {name}, {label}: {differ} differ, launches "
                                     f"{la} / {lb}")
        if kname is not None:
            ekernel = {"colored_gibbs_sweep": "sparse_energy",
                       "lattice_gibbs_sweep": "lattice_energy"}.get(kname)
            energy = ({ekernel: energy_launches(FAULT_STEPS, FAULT_SAMPLE_EVERY, targets[name])}
                      if ekernel else {})
            want_f = dict(zero, **{kname + "_faults": 2 * FAULT_STEPS}, **energy)
            want_c = dict(zero, **{kname: 2 * FAULT_STEPS}, **energy)
        else:
            want_f = want_c = zero
        if f_l != want_f or c_l != want_c:
            raise AssertionError(f"faults {name}: launches {f_l} under faults (expected "
                                 f"{want_f}), {c_l} without (expected {want_c})")
        m = mask.reshape(-1)
        v = values.reshape(-1)[m]
        stuck_ok = bool((f_res.s.flatten(1)[:, m] == v).all()
                        and (f_res.samples.flatten(2)[:, :, m] == v).all())
        if not stuck_ok:
            raise AssertionError(f"faults {name}: a stuck site left its value")
        # dropout = 1: every update lost, the state frozen (the CTMC's clock runs on)
        s0 = torch.where(torch.rand((chains,) + state_shape(problem), device=dev) < 0.5,
                         1.0, -1.0)
        reset()
        frozen = run(problem, kernel, 7, n_steps=20, s0=s0, n_chains=chains, backend=backend,
                     faults=FaultModel(dropout=1.0))
        drop_l = read()
        t_ok = not isinstance(kernel, CTMC) or bool((frozen.t > 0).all())
        if not torch.equal(frozen.s, s0) or not t_ok:
            raise AssertionError(f"faults {name}: dropout=1 changed the state or stopped the "
                                 f"CTMC's clock (t > 0: {t_ok})")
        launches[name] = f_l
        out[name] = {
            "n_chains": chains, "n_steps": FAULT_STEPS, "stuck_sites": int(mask.sum()),
            "identical_graph_eager": list(fields), "noop_identical_to_none": True,
            "stuck_never_left": stuck_ok, "dropout_1_frozen": True,
            "launches": {k: c for k, c in f_l.items() if c},
            "launches_clean": {k: c for k, c in c_l.items() if c},
            "launches_dropout_1": {k: c for k, c in drop_l.items() if c},
            "graph_us_per_step_faults": f_wall / FAULT_STEPS * 1e6,
            "graph_us_per_step_clean": c_wall / FAULT_STEPS * 1e6,
            "eager_us_per_step_faults": e_wall / FAULT_STEPS * 1e6,
            "hit_fraction_faults": float(f_res.hit.float().mean()),
            "hit_fraction_clean": float(c_res.hit.float().mean()),
        }
    emit({"phase": "faults", "faults": {k: v for k, v in FAULTS.items()}, "paths": out,
          "nvidia_smi": smi})
    return launches


def apps_phase(torch, dev, sk, reset, read, smi) -> None:
    """The applications on the card (module docstring, phase `apps`)."""
    from repro_torch.core import boltzmann, decision, tempering
    from repro_torch.data import digits

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    zero = dict.fromkeys(read(), 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = digits.digit_batch(3, 64, gen, 0.05, device=dev)
    cd = {}
    state = None
    for label, cfg in (("default", boltzmann.CDConfig()),
                       ("chromatic", boltzmann.CDConfig(sampler="chromatic"))):
        state = boltzmann.init_cd(gen, 16, 16, cfg, device=dev)
        e0 = float(boltzmann.free_energy_proxy(state.problem, batch))
        reset()

        def train(state=state, cfg=cfg):
            for _ in range(CD_STEPS):
                state = boltzmann.cd_step(state, batch, gen, cfg)
            return state

        state, wall = walled(train)
        launches = read()
        want = zero if cfg.sampler == "pass" else dict(  # and the start state's energy a step
            zero, lattice_gibbs_sweep=CD_STEPS * cfg.n_model_steps, lattice_energy=CD_STEPS)
        e1 = float(boltzmann.free_energy_proxy(state.problem, batch))
        if launches != want or not abs(e1) < float("inf"):
            raise AssertionError(f"cd {label}: launches {launches} (expected {want}), "
                                 f"data energy {e1}")
        cd[label] = {"config": {k: v for k, v in vars(cfg).items()}, "cd_steps": CD_STEPS,
                     "wall_s": wall, "data_energy_before": e0, "data_energy_after": e1,
                     "launches": {k: c for k, c in launches.items() if c}}
    known = torch.zeros((16, 16), dtype=torch.bool, device=dev)
    known[:8] = True
    rec, rec_wall = walled(lambda: boltzmann.reconstruct(state.problem, gen, batch[0], known))
    if not torch.equal(rec[:8], batch[0][:8]):
        raise AssertionError("reconstruct changed the clamped half")
    template = torch.as_tensor(digits.digit_template(3), device=dev)

    t = TEMPERING
    st = tempering.init(sk, gen, list(t["betas"]))
    (st, trace), pt_wall = walled(lambda: tempering.run(
        sk, gen, st, n_rounds=t["n_rounds"], steps_per_round=t["steps_per_round"]))
    if not torch.allclose(st.energies, sk.energy(st.s), rtol=1e-5, atol=1e-3):
        raise AssertionError("tempering: the replicas' energies are not their states'")

    cfg = decision.DecisionConfig()
    traj, dec_wall = walled(lambda: decision.simulate(0, DECISION_TARGETS, cfg, device=dev))
    if not bool(torch.isfinite(traj.positions).all()):
        raise AssertionError("decision: non-finite positions")
    emit({"phase": "apps", "boltzmann_cd": cd, "reconstruct": {
              "wall_s": rec_wall, "clamped_half_exact": True,
              "free_half_agreement_with_template": float(
                  (rec[8:] == template[8:]).float().mean())},
          "tempering": {"problem": f"sk_instance({sk.n}, 0)", **t, "wall_s": pt_wall,
                        "swaps": int(st.n_swaps), "best_energy_per_spin":
                        float(trace.min()) / sk.n},
          "decision": {"config": vars(cfg), "wall_s": dec_wall,
                       "arrived": bool(traj.arrived),
                       "bifurcation_distance": float(decision.bifurcation_distance(
                           traj.positions, DECISION_TARGETS))},
          "nvidia_smi": smi})


def serve_requests(np, cfg, n: int) -> list:
    """(prompt, extras) of the n requests launch.serve.main submits: 4 to 15
    tokens from seed 0; a vlm's with N(0, 0.02) image patches (n_patches,
    d_model) from seed 1, an encoder-decoder's with N(0, 0.02) frames
    (encoder_seq, d_model) from seed 1."""
    rng, prng = np.random.default_rng(0), np.random.default_rng(1)
    reqs = []
    for _ in range(n):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32)
        extras = None
        if cfg.family == "vlm":
            extras = {"patch_embeds": prng.normal(0.0, 0.02, (cfg.n_patches, cfg.d_model)).astype(
                np.float32)}
        if cfg.family == "audio":
            extras = {"frames": prng.normal(0.0, 0.02, (cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)}
        reqs.append((prompt, extras))
    return reqs


def long_request(np, cfg, length: int) -> list:
    """One prompt of `length` random tokens from seed 2, no extras."""
    return [(np.random.default_rng(2).integers(0, cfg.vocab_size, size=length).astype(np.int32),
             None)]


def serve_max_len(cfg) -> int:
    return SERVE_VLM_MAX_LEN if cfg.family == "vlm" else SERVE_MAX_LEN


def greedy_runs(cfg, params, requests, max_len, modes, reset, read) -> dict:
    """Greedy runs of `requests` ((prompt, extras) pairs), one per prefill
    attention mode, keeping every sampled logits row: {mode: (tokens by uid,
    logits rows by uid, launches, prefill seconds, decode seconds)}."""
    import torch
    from repro_torch.serve.engine import Engine, Request

    runs = {}
    for mode in modes:
        eng = Engine(cfg, params, n_slots=SERVE_SLOTS, max_len=max_len, seed=0,
                     device=params.device, mode=mode, keep_logits=True)
        for uid, (prompt, extras) in enumerate(requests):
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=SERVE_MAX_NEW,
                               extras=extras))
        reset()
        done = eng.run()
        if params.device.type == "cuda":
            torch.cuda.synchronize()
        runs[mode] = ({c.uid: c.tokens for c in done}, eng.sampled_logits, read(),
                      eng.prefill_s, eng.decode_s)
    return runs


def serve_gate(kernel, plain, margin: float) -> dict:
    """Hold a greedy run against the plain one: each request's last-position
    prefill logits by relative L2 error; at each position whose context is
    the same in both runs (up to each request's first differing token), the
    token is held where the plain run's top-1 minus top-2 margin exceeds
    `margin` times the plain row's RMS (a fixed SERVE_MARGIN, not taken from
    the run under test), and counted a near tie elsewhere. Returns the
    counts; the caller gates on `tokens_flipped` and `tokens_held`."""
    (tok_k, rows_k, *_), (tok_p, rows_p, *_) = kernel, plain
    rel = {uid: float((rows_k[uid][0] - rows_p[uid][0]).norm() / rows_p[uid][0].norm())
           for uid in rows_p}
    same = {uid: next((j + 1 for j, (a, b) in enumerate(zip(tok_k[uid], tok_p[uid])) if a != b),
                      len(tok_p[uid])) for uid in tok_p}
    held, near_ties, flipped, deviation, rel_deviation, margins = 0, 0, [], 0.0, 0.0, []
    for uid in rows_p:
        for j in range(same[uid]):
            row_k, row_p = rows_k[uid][j], rows_p[uid][j]
            rms = float(row_p.square().mean().sqrt())
            dev = float((row_k - row_p).abs().max())
            deviation, rel_deviation = max(deviation, dev), max(rel_deviation, dev / rms)
            top2 = row_p.topk(2).values
            margins.append(float(top2[0] - top2[1]) / rms)
            if float(top2[0] - top2[1]) <= margin * rms:
                near_ties += 1
            elif tok_k[uid][j] != tok_p[uid][j]:
                flipped.append([uid, j, tok_k[uid][j], tok_p[uid][j],
                                float(top2[0] - top2[1]) / rms])
            else:
                held += 1
    return {"prefill_logits_rel_l2": rel, "max_rel_l2": max(rel.values()),
            "max_logit_deviation": deviation, "max_rel_deviation": rel_deviation,
            "margin": margin, "tokens_held": held, "tokens_flipped": flipped,
            "plain_margins_over_rms": sorted(margins, reverse=True),
            "near_tie_positions": near_ties,
            "positions_after_a_difference": sum(len(t) - same[u] for u, t in tok_p.items()),
            "requests_identical": sum(tok_k[u] == tok_p[u] for u in tok_p)}


def _hold_greedy(arch, cfg, runs, want, zero, what="greedy") -> dict:
    """The serve gates of a kernel and a plain greedy run (serve_gate):
    launches as wanted (none on the plain run), the prefill logits within
    SERVE_LOGITS_RTOL, no token flipped above SERVE_MARGIN, some token held
    unless the family is moe. Returns the gate's counts with the tolerance."""
    if runs["kernel"][2] != want or runs["reference"][2] != zero:
        raise AssertionError(f"serve {arch} {what}: launches {runs['kernel'][2]} with the "
                             f"kernel (expected {want}), {runs['reference'][2]} plain")
    tol, margin = SERVE_LOGITS_RTOL[cfg.family], SERVE_MARGIN[cfg.family]
    gate = serve_gate(runs["kernel"], runs["reference"], margin)
    if not gate["max_rel_l2"] <= tol:
        raise AssertionError(f"serve {arch} {what}: prefill logits rel L2 {gate['max_rel_l2']} "
                             f"> {tol}")
    if gate["tokens_flipped"] or (cfg.family != "moe" and not gate["tokens_held"]):
        raise AssertionError(f"serve {arch} {what}: greedy tokens [uid, j, kernel, plain, "
                             f"margin/RMS] differing where the plain margin exceeds {margin} "
                             f"RMS: {gate['tokens_flipped']}; {gate['tokens_held']} held")
    return dict(gate, tol=tol)


def serve_phase(torch, np, dev, reset, read, smi, err) -> dict:
    """The serving stack at full width (module docstring, phase `serve`).
    Returns the flash kernel's launches on the served runs (all, and banded),
    its times at phi4-mini's serving prefill shape; folds its checks into
    `err`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import serve
    from repro_torch.models import model, transformer
    from repro_torch.serve.engine import Request

    zero = dict.fromkeys(read(), 0)
    by_arch, launches_total, launches_window, launches_kv_len = {}, 0, 0, 0
    for arch, n_requests in SERVE_MODELS:
        cfg = get_config(arch)
        hd, max_len = cfg.resolved_head_dim, serve_max_len(cfg)
        n_attn = sum(kind in transformer.ATTENTION_KINDS for kind in transformer.layer_kinds(cfg))
        # an encoder-decoder's prefill also runs each encoder layer's and each
        # cross-attention's kernel, bounded to the frames (kv_len)
        n_bounded = cfg.n_encoder_layers + cfg.n_layers if cfg.is_encdec else 0
        n_flash = n_attn + n_bounded
        want = dict(zero, flash_attention=n_flash * n_requests,
                    flash_attention_bf16=n_flash * n_requests,
                    flash_attention_kv_len=n_bounded * n_requests)
        requests = serve_requests(np, cfg, n_requests)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset()
        if cfg.family in ("vlm", "audio"):  # launch.serve.main submits no extras, as JAX's
            params = model.init_params(cfg, 0, dev)
            out = serve.serve(cfg, params, [
                Request(uid=uid, prompt=prompt, max_new_tokens=SERVE_MAX_NEW, temperature=0.7,
                        extras=extras) for uid, (prompt, extras) in enumerate(requests)],
                slots=SERVE_SLOTS, max_len=max_len)
        else:
            out = serve.main(["--arch", arch, "--requests", str(n_requests), *SERVE_ARGS])
            params = model.init_params(cfg, 0, dev)
        torch.cuda.synchronize()
        launches = read()
        peak = torch.cuda.max_memory_allocated()
        lengths = sorted(len(c["tokens"]) for c in out["completions"])
        if launches != want or lengths != [SERVE_MAX_NEW] * n_requests or out["nonfinite_logits"]:
            raise AssertionError(f"serve {arch}: launches {launches} (expected {want}), "
                                 f"completion lengths {lengths}, non-finite logits "
                                 f"{out['nonfinite_logits']}")
        launches_total += launches["flash_attention"]
        launches_kv_len += launches["flash_attention_kv_len"]

        # the decode step reads every weight but the embedding table (only
        # its B rows, unless it is the tied head), an encoder's layers and
        # the cross-attentions' wk and wv (the cross K/V are cached), and
        # every layer's state, and writes back the recurrent states whole
        # (a KV cache: one row)
        caches = model.init_caches(cfg, SERVE_SLOTS, max_len, dev)
        state_bytes = [sum(t.numel() * t.element_size() for t in st) for st in caches]
        recurrent_bytes = sum(b for st, b in zip(caches, state_bytes) if not hasattr(st, "k"))
        del caches
        embed_bytes = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model * 2
        unread_bytes = 0
        if cfg.is_encdec:
            unread_bytes = sum(p.numel() * p.element_size() for p in (
                *params.enc_layers.parameters(), *params.enc_norm.parameters(),
                *(w for c in params.cross for w in (c.attn.wk.weight, c.attn.wv.weight))))
        decode_bytes = (out["weight_bytes"] - embed_bytes - unread_bytes + sum(state_bytes)
                        + recurrent_bytes)

        # greedy, with the kernel and with the plain attention, same weights
        # and prompts (without an attention layer both runs are the same)
        gate = long = None
        if n_attn:
            runs = greedy_runs(cfg, params, requests, max_len, ("kernel", "reference"), reset,
                               read)
            gate = _hold_greedy(arch, cfg, runs, want, zero)
            del runs
        if arch in SERVE_LONG:  # a prompt past the window: the ring branch, the band
            length, long_len = SERVE_LONG[arch]
            want_long = dict(zero, flash_attention=n_attn, flash_attention_bf16=n_attn,
                             flash_attention_window=n_attn)
            torch.cuda.reset_peak_memory_stats()
            runs = greedy_runs(cfg, params, long_request(np, cfg, length), long_len,
                               ("kernel", "reference"), reset, read)
            long = {"prompt": length, "max_len": long_len,
                    **_hold_greedy(arch, cfg, runs, want_long, zero, "long request"),
                    "launches": {k_: c for k_, c in runs["kernel"][2].items() if c},
                    "prefill_ms": 1e3 * runs["kernel"][3][0],
                    "decode_ms_median": 1e3 * statistics.median(runs["kernel"][4]),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
            launches_total += runs["kernel"][2]["flash_attention"]
            launches_window += runs["kernel"][2]["flash_attention_window"]
            del runs
        del params
        torch.cuda.empty_cache()

        flash_check = None
        if n_attn:  # the kernel at this model's serving prefill shape: one prompt, padded
            S = -(-(cfg.n_patches + 15) // 128) * 128
            q, k, v = (0.5 * torch.randn((cfg.n_heads, S, hd), device=dev, dtype=torch.bfloat16)
                       for _ in range(3))
            e, ulps = check_attention(torch, ops, f"serve {arch}", flash_attention.flash_attention(
                q, k, v, True), q, k, v, True)
            err["flash_attention"] = max(err["flash_attention"], e)
            flash_check = {"shape": [cfg.n_heads, S, S, hd], "max_abs_err": e,
                           "max_bf16_ulps": ulps}
        if cfg.is_encdec:  # and its encoder's and cross-attention's, bounded to the frames
            T = cfg.encoder_seq
            Tp = -(-T // 128) * 128
            for name, Sq in (("encoder", Tp), ("cross", S)):
                q = 0.5 * torch.randn((cfg.n_heads, Sq, hd), device=dev, dtype=torch.bfloat16)
                k, v = (0.5 * torch.randn((cfg.n_heads, Tp, hd), device=dev, dtype=torch.bfloat16)
                        for _ in range(2))
                e, ulps = check_attention(
                    torch, ops, f"serve {arch} {name}",
                    flash_attention.flash_attention(q, k, v, False, kv_len=T), q, k, v, False,
                    kv_len=T)
                err["flash_attention_kv_len"] = max(err["flash_attention_kv_len"], e)
                flash_check[name] = {"shape": [cfg.n_heads, Sq, Tp, hd], "kv_len": T,
                                     "max_abs_err": e, "max_bf16_ulps": ulps}
        if arch in SERVE_LONG:  # and at the long request's banded shape
            S = -(-SERVE_LONG[arch][0] // 128) * 128
            q, k, v = (0.5 * torch.randn((cfg.n_heads, S, hd), device=dev, dtype=torch.bfloat16)
                       for _ in range(3))
            out_k = flash_attention.flash_attention(q, k, v, True, cfg.window)
            e, ulps = check_attention(torch, ops, f"serve {arch} long", out_k, q, k, v, True,
                                      cfg.window)
            err["flash_attention_window"] = max(err["flash_attention_window"], e)
            flash_check["long"] = {"shape": [cfg.n_heads, S, S, hd], "window": cfg.window,
                                   "max_abs_err": e, "max_bf16_ulps": ulps}
        by_arch[arch] = {
            "family": cfg.family, "n_layers": cfg.n_layers, "attention_layers": n_attn,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": hd,
            "vocab": cfg.vocab_size, "requests": n_requests, "max_len": max_len,
            "weight_bytes": out["weight_bytes"], "max_memory_allocated": peak,
            "launches": {k_: c for k_, c in launches.items() if c},
            "prefill_ms_median": statistics.median(out["prefill_ms"]),
            "prefill_ms": out["prefill_ms"], "decode_ms_median": out["decode_ms_median"],
            "decode_steps": len(out["decode_ms"]), "tokens": out["tokens"],
            "wall_s": out["wall_s"], "tokens_per_s": out["tokens_per_s"],
            "weight_read_bound_ms": out["weight_bytes"] / HBM_BYTES_PER_S * 1e3,
            "decode_bound_ms": decode_bytes / HBM_BYTES_PER_S * 1e3, "decode_bytes": decode_bytes,
            "vs_plain": gate, "long_request": long, "flash_check": flash_check}
        emit({"phase": "serve", "arch": arch, **by_arch[arch], "nvidia_smi": smi})

    # flash_attention at phi4-mini's serving prefill shape (24, 128, 128),
    # bf16 causal, beside its plain version and SDPA; bound as in `timing`
    hq, S, d = 24, 128, 128
    q, k, v = (0.5 * torch.randn((hq, S, d), device=dev, dtype=torch.bfloat16) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {"ms": time_ms(torch, lambda: flash_attention.flash_attention(q, k, v, True)),
              "plain_ms": time_ms(torch, lambda: ops.flash_attention(q, k, v, True,
                                                                     mode="reference")),
              "library_ms": time_ms(torch, lambda: sdpa(q[None], k[None], v[None],
                                                        is_causal=True))}
    timing["bound_ms"], timing["bound_by"] = bound(4 * hq * S * d * 2, 4.0 * d * hq * S * (S + 1) / 2,
                                                   BF16_OPS_PER_S)
    emit({"phase": "serve_flash_timing", "shape": [hq, S, d], "dtype": "bfloat16", "causal": True,
          **timing, "nvidia_smi": smi})
    return {"launches": launches_total, "launches_window": launches_window,
            "launches_kv_len": launches_kv_len, "shape": [hq, S, d], **timing}


# -- training (slice 12) ------------------------------------------------------------

# the main path: launch.train.train at full width in bf16, the driver's
# defaults otherwise (lr 3e-3, warmup 2, the cosine over the run); 4096
# tokens a step, so every attention takes the dense path
TRAIN_FULL = dict(arch="gemma-2b", steps=10, batch=4, seq=1024)
# the least drop from the first loss to the last of that run (step 0 learns
# nothing: its lr scale is 0): less than half of the 3.364 that both
# `--card-train-gates` runs gave (12.656 to 9.292, equal to the last digit)
TRAIN_LOSS_DROP = 1.5
# each family's reduced config (float32) on the card against the CPU, two
# make_train_step steps from the same weights, batches and Gumbel draws:
# the losses, grad norms and the params after step 2, relative L2, within
# TRAIN_CARD_RTOL: about 4x the largest difference both `--card-train-gates`
# runs gave (xlstm-125m's params, 1.33e-5; the losses within 7.7e-8)
TRAIN_FAMILIES = (("gemma-2b", None), ("olmoe-1b-7b", "boltzmann"), ("internvl2-2b", None),
                  ("recurrentgemma-9b", None), ("xlstm-125m", None), ("whisper-medium", None))
TRAIN_CARD_RTOL = 5e-5
# checkpoint and resume at full width through launch.train.main: 6 steps
# saving at 3 (and 6), then a fresh run from step 3 alone
TRAIN_RESUME = ["--arch", "xlstm-125m", "--steps", "6", "--ckpt-every", "3", "--batch", "4",
                "--seq", "128"]
TRAIN_OPT_BYTES = 22  # a parameter's AdamW traffic: bf16 grad read, f32 mu and nu and bf16
# param read and written


def _train_main(main, argv) -> tuple[dict, str]:
    """A driver's main run with its printed lines captured."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = main(argv)
    return out, printed.getvalue()


def train_full_width(torch, dev, reset, read, smi, hold: bool) -> dict:
    """The main path (module docstring, phase `train`, part full_width).
    Returns its losses, ms a step and peak bytes (the shard phase's baseline)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig

    f = TRAIN_FULL
    cfg = get_config(f["arch"])
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3), total_steps=f["steps"],
                       warmup_steps=max(2, f["steps"] // 20))
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    out, printed = _train_main(lambda _: train.train(cfg, tcfg, steps=f["steps"], batch=f["batch"],
                                                     seq=f["seq"], device=dev), None)
    wall = time.perf_counter() - t0
    launches = {k: c for k, c in read().items() if c}
    state = out.pop("state")
    n = out["n_params"]
    state_bytes = sum(t.numel() * t.element_size() for t in state.params.parameters()) * 2 + sum(
        t.numel() * 4 for t in (*state.opt.mu.values(), *state.opt.nu.values()))
    del state
    torch.cuda.empty_cache()
    tokens = out["tokens_per_step"]
    ms = statistics.median(out["step_ms"][1:])
    flops_ms = 1e3 * 6 * n * tokens / BF16_OPS_PER_S
    opt_ms = 1e3 * TRAIN_OPT_BYTES * n / HBM_BYTES_PER_S
    losses = out["losses"]
    drop = losses[0] - losses[-1]
    emit({"phase": "train", "part": "full_width", **f, "dtype": cfg.dtype, "remat": cfg.remat,
          "n_params": n, "losses": losses, "grad_norms": out["grad_norms"], "loss_drop": drop,
          "step_ms": out["step_ms"], "ms_per_step_median": ms,
          "tokens_per_s": tokens / ms * 1e3, "peak_bytes": out["peak_bytes"],
          "state_bytes": state_bytes, "bound_ms": flops_ms + opt_ms,
          "bound_flops_ms": flops_ms, "bound_optimizer_ms": opt_ms,
          "flash_launches": launches, "wall_s": wall,
          "printed": printed.strip().splitlines()[-3:], "nvidia_smi": smi})
    finite = all(math.isfinite(x) for x in losses + out["grad_norms"])
    if hold and (not finite or launches or drop < TRAIN_LOSS_DROP):
        raise AssertionError(f"train full width: finite {finite}, kernel launches {launches}, "
                             f"loss drop {drop} (at least {TRAIN_LOSS_DROP})")
    return {"losses": losses, "ms_per_step_median": ms, "peak_bytes": out["peak_bytes"]}


def _rel(torch, got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30))


def train_card_vs_cpu(torch, np, dev, arch, router, hold: bool) -> None:
    """One family's reduced config, two train steps on the card and on the
    CPU from the same weights, batches and draws (part card_vs_cpu)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    cfg = get_config(arch, reduced=True)
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_mode=router))
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        ids = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int64)
        b = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.normal(0, 0.02, (4, cfg.n_patches, cfg.d_model))
        if cfg.family == "audio":
            b["frames"] = rng.normal(0, 0.02, (4, cfg.encoder_seq, cfg.d_model))
        batches.append({k: torch.as_tensor(v.astype(np.float32) if v.dtype == np.float64 else v)
                        for k, v in b.items()})
    runs = {}
    for where in ("cpu", dev):
        state = init_state(cfg, tcfg, 0, where)
        if where != "cpu":  # the CPU run's weights
            state.params.load_state_dict(runs["cpu"]["init"])
        init = {k: v.clone() for k, v in state.params.state_dict().items()}
        step_fn, metrics = make_train_step(cfg, tcfg), []
        for i, b in enumerate(batches):
            state, m = step_fn(state, {k: v.to(where) for k, v in b.items()},
                               torch.Generator().manual_seed(i))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[str(where)] = {"init": init, "metrics": metrics,
                            "params": dict(state.params.named_parameters())}
    cpu, card = runs["cpu"], runs[str(dev)]
    err = {k: max(abs(c[k] - g[k]) / max(abs(c[k]), 1e-30)
                  for c, g in zip(cpu["metrics"], card["metrics"]))
           for k in ("loss", "ce_loss", "grad_norm")}
    err["params"] = max(_rel(torch, card["params"][n], p) for n, p in cpu["params"].items())
    moved = math.sqrt(sum(float((p.detach() - cpu["init"][n]).square().sum())
                          for n, p in cpu["params"].items())
                      / sum(float(t.square().sum()) for t in cpu["init"].values()))
    worst = max(err.values())
    emit({"phase": "train", "part": "card_vs_cpu", "arch": arch, "router": router,
          "losses_cpu": [m["loss"] for m in cpu["metrics"]],
          "losses_card": [m["loss"] for m in card["metrics"]], "rel_err": err,
          "params_moved": moved, "gate": TRAIN_CARD_RTOL})
    if hold and not worst <= TRAIN_CARD_RTOL:
        raise AssertionError(f"train {arch}: card against CPU {err} (gate {TRAIN_CARD_RTOL})")


def train_resume(torch, dev, smi, hold: bool) -> None:
    """Checkpoint and resume at full width, then serve from the checkpoint
    (parts resume and serve_restored), under torch's deterministic
    algorithms."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.train import checkpoint

    cfg = get_config(TRAIN_RESUME[1])
    args = [*TRAIN_RESUME, "--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        whole, crashed = os.path.join(tmp, "whole"), os.path.join(tmp, "crashed")
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            a, _ = _train_main(train.main, [*args, "--ckpt-dir", whole])
            shutil.copytree(os.path.join(whole, "step_000000003"),
                            os.path.join(crashed, "step_000000003"))
            b, printed = _train_main(train.main, [*args, "--ckpt-dir", crashed])
            wall = time.perf_counter() - t0
            tensors = [checkpoint._flatten(checkpoint.restore(d, 6)) for d in (whole, crashed)]
            differ = [k for k in tensors[0] if not torch.equal(tensors[0][k], tensors[1][k])]
            max_abs = max(float((tensors[0][k].double() - tensors[1][k].double()).abs().max())
                          for k in tensors[0])
            disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                       os.walk(os.path.join(whole, "step_000000006")) for f in fs)
            emit({"phase": "train", "part": "resume", "argv": args,
                  "losses_whole": a["losses"], "losses_resumed": b["losses"],
                  "start_resumed": b["start"], "recovery_line": printed.splitlines()[0],
                  "leaves": len(tensors[0]), "leaves_differing": len(differ),
                  "max_abs_diff": max_abs, "checkpoint_bytes": disk,
                  "step_ms_whole": a["step_ms"], "wall_s": wall,
                  "deterministic": torch.are_deterministic_algorithms_enabled(),
                  "nvidia_smi": smi})
            ok = (not differ and b["start"] == 3 and a["losses"][3:] == b["losses"]
                  and printed.startswith("[recovery] resumed from committed step 3"))
            if hold and not ok:
                raise AssertionError(f"train resume: {len(differ)} leaves differ ({differ[:5]}), "
                                     f"start {b['start']}, losses {a['losses']} / {b['losses']}")
            argv = ["--arch", cfg.name, "--no-reduced", "--requests", "4", "--device", dev.type]
            served, printed = _train_main(serve.main, [*argv, "--ckpt-dir", crashed])
            want = serve.serve(cfg, b["state"].params, serve.requests(cfg, 4, 12, 0.7),
                               slots=4, max_len=128)
            fresh, _ = _train_main(serve.main, argv)
        finally:
            torch.use_deterministic_algorithms(False)
    same = served["completions"] == want["completions"]
    emit({"phase": "train", "part": "serve_restored", "restored_step": served["restored_step"],
          "printed": printed.strip().splitlines()[0], "tokens": served["tokens"],
          "equal_to_the_trained_params": same,
          "differs_from_random_init": served["completions"] != fresh["completions"]})
    if hold and not (same and served["restored_step"] == 6
                     and served["completions"] != fresh["completions"]):
        raise AssertionError(f"serve --ckpt-dir: restored step {served['restored_step']}, equal "
                             f"to the trained params {same}")


def train_phase(torch, np, dev, reset, read, smi, hold: bool = True) -> dict:
    """Training (module docstring, phase `train`); with `hold` off (the
    calibration of --card-train-gates) the numbers only. Returns the full
    width run's baseline (`train_full_width`)."""
    baseline = train_full_width(torch, dev, reset, read, smi, hold)
    reset()
    for arch, router in TRAIN_FAMILIES:
        train_card_vs_cpu(torch, np, dev, arch, router, hold)
    train_resume(torch, dev, smi, hold)
    launches = {k: c for k, c in read().items() if c}
    if launches:  # training launches no kernel
        raise AssertionError(f"train: kernel launches {launches}")
    return baseline


# -- the scale-out stack (slice 13) ------------------------------------------------

# the rule sets the (1, 1) sharded step runs under (launch.specs.rules_for)
SHARD_STRATEGIES = ("tp_sp", "fsdp_pure")
# the dry-run cells, each in a child process (a fake world of 256 ranks)
# through launch.dryrun.sweep: gemma-2b's decode, one cell of each class of layout torch
# 2.11's DTensor refuses unless the models state it (the grouped scores
# under context parallelism, the MoE's combine, the RG-LRU's conv), and
# qwen1p5-32b's prefill, the padded-head TP layout
SHARD_DRYRUN = [("gemma-2b", "decode_32k", "single"), ("gemma-2b", "train_4k", "single"),
                ("qwen2-moe-a2p7b", "prefill_32k", "single"),
                ("recurrentgemma-9b", "train_4k", "single"),
                ("qwen1p5-32b", "prefill_32k", "single")]
# the 2x2 gloo mesh of 4 CPU processes: reduced configs' sharded train steps
# against the unsharded step: gemma-2b under each of SHARD_STRATEGIES,
# qwen2-moe-a2p7b with 3 experts (the tensor axis of 2 does not divide them:
# TP on their FFN width; no qkv bias, whose k bias has a zero gradient but
# for rounding, which AdamW scales to steps of the learning rate's size) and
# recurrentgemma-9b (the RG-LRU's gates, conv and scan on local shards)
SHARD_GLOO = {"steps": 2, "batch": 4, "seq": 16, "rtol": 2e-5,
              "cases": [{"arch": "gemma-2b", "strategy": s} for s in SHARD_STRATEGIES]
              + [{"arch": "qwen2-moe-a2p7b", "strategy": "tp_sp", "n_experts": 3,
                  "qkv_bias": False},
                 {"arch": "recurrentgemma-9b", "strategy": "tp_sp"}]}
_GLOO_WORKER = r"""
import json, sys
import torch, torch.distributed as dist
rank, tmp, spec, src = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=4)
torch.set_num_threads(1)
sys.path.insert(0, src)
from chip_smoke import gloo_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import train
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig
mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
res = {}
for i, case in enumerate(spec["cases"]):
    s = train(gloo_config(case), tcfg, steps=spec["steps"], batch=spec["batch"],
              seq=spec["seq"], device="cpu", ckpt_dir=f"{tmp}/{i}", mesh=mesh)
    res[i] = {"losses": s["losses"], "grad_norms": s["grad_norms"], "rules": s["rules"]}
    full = {n: p.full_tensor() for n, p in s["state"].params.named_parameters()}
    if rank == 0:
        torch.save(full, f"{tmp}/{i}.pt")
if rank == 0:
    with open(f"{tmp}/result.json", "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
"""


def gloo_config(case: dict):
    """The reduced config of a SHARD_GLOO case."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(case["arch"], reduced=True), strategy=case["strategy"])
    if "n_experts" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=case["n_experts"]))
    if "qkv_bias" in case:
        cfg = dataclasses.replace(cfg, qkv_bias=case["qkv_bias"])
    return cfg


def shard_step(torch, dev, reset, read, smi, baseline: dict) -> None:
    """Part (1, 1) of phase `shard` (module docstring): the train phase's
    full-width run again through launch.train.train on a (1, 1) NCCL mesh,
    under each of SHARD_STRATEGIES, held to the unsharded run's losses."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig

    f = TRAIN_FULL
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3), total_steps=f["steps"],
                       warmup_steps=max(2, f["steps"] // 20))
    with tempfile.TemporaryDirectory() as tmp:
        cuda = dev.type == "cuda"  # the CPU only in a rehearsal, on gloo
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev if cuda else None)
        try:
            mesh = make_test_mesh((1, 1), ("data", "model"), dev.type)
            for strategy in SHARD_STRATEGIES:
                cfg = dataclasses.replace(get_config(f["arch"]), strategy=strategy)
                torch.cuda.empty_cache()
                reset()
                t0 = time.perf_counter()
                out, printed = _train_main(lambda _: train.train(
                    cfg, tcfg, steps=f["steps"], batch=f["batch"], seq=f["seq"], device=dev,
                    mesh=mesh), None)
                wall = time.perf_counter() - t0
                del out["state"]
                torch.cuda.empty_cache()
                launches = {k: c for k, c in read().items() if c}
                losses, want = out["losses"], baseline["losses"]
                worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
                ms = statistics.median(out["step_ms"][1:])
                emit({"phase": "shard", "part": "mesh_1x1", "strategy": strategy, **f,
                      "mesh": out["mesh"], "rules": out["rules"], "losses": losses,
                      "unsharded_losses": want, "losses_max_rel": worst,
                      "bit_equal": losses == want, "gate": TRAIN_CARD_RTOL,
                      "grad_norms": out["grad_norms"], "step_ms": out["step_ms"],
                      "ms_per_step_median": ms,
                      "ratio_to_unsharded": ms / baseline["ms_per_step_median"],
                      "unsharded_ms_per_step_median": baseline["ms_per_step_median"],
                      "peak_bytes": out["peak_bytes"],
                      "unsharded_peak_bytes": baseline["peak_bytes"],
                      "flash_launches": launches, "wall_s": wall,
                      "printed": printed.strip().splitlines()[-2:], "nvidia_smi": smi})
                finite = all(math.isfinite(x) for x in losses + out["grad_norms"])
                if not (finite and worst <= TRAIN_CARD_RTOL) or launches:
                    raise AssertionError(f"shard {strategy}: losses {worst} from the unsharded "
                                         f"run (gate {TRAIN_CARD_RTOL}), finite {finite}, "
                                         f"kernel launches {launches}")
        finally:
            dist.destroy_process_group()


def shard_dryrun(smi) -> None:
    """Part dryrun of phase `shard`: the SHARD_DRYRUN cells through
    launch.dryrun.sweep, each in a child process of its own (the fake world
    and NCCL cannot share one), as many at once as the host has cores;
    every record `ok`."""
    import tempfile

    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory() as art:
        t0 = time.perf_counter()
        recs = dryrun.sweep(SHARD_DRYRUN, force=True, art_dir=art)
        wall = time.perf_counter() - t0
    bad = []
    for (arch, shape, mesh), rec in zip(SHARD_DRYRUN, recs):
        emit({"phase": "shard", "part": "dryrun", "cell": [arch, shape, mesh],
              "status": rec["status"], "n_params": rec.get("n_params"),
              "trace_s": rec.get("trace_s"), "roofline": rec.get("roofline"),
              "collectives": rec.get("collectives"), "memory": rec.get("memory"),
              "error": rec.get("error"), "torch": _torch_version(), "nvidia_smi": smi})
        if rec["status"] != "ok":
            bad.append(f"{arch} x {shape} x {mesh}: {rec['status']}: {rec.get('error')}")
    emit({"phase": "shard", "part": "dryrun_all", "cells": len(SHARD_DRYRUN), "wall_s": wall})
    if bad:
        raise AssertionError("shard dryrun: " + "; ".join(bad))


def _torch_version() -> str:
    import torch

    return torch.__version__


def shard_gloo(smi) -> None:
    """Part gloo_2x2 of phase `shard` (module docstring): each SHARD_GLOO
    case's train steps on a 2x2 mesh of 4 gloo processes on the host's CPU,
    held within SHARD_GLOO["rtol"] of the port's unsharded step from the
    same seed: losses, grad norms and every parameter after the steps."""
    import tempfile

    import torch

    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig

    g = SHARD_GLOO
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-W", "ignore", "-c", _GLOO_WORKER, str(r),
                                   tmp, json.dumps(g), str(Path(__file__).resolve().parent)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(4)]
        outs = [p.communicate(timeout=600) for p in procs]
        wall = time.perf_counter() - t0
        for p, (_, err) in zip(procs, outs):
            if p.returncode:
                raise AssertionError(f"shard gloo_2x2: a worker exited {p.returncode}: "
                                     f"{err[-2000:]}")
        res = json.loads(Path(tmp, "result.json").read_text())
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
        for i, case in enumerate(g["cases"]):
            plain, _ = _train_main(lambda _: train.train(
                gloo_config(case), tcfg, steps=g["steps"], batch=g["batch"], seq=g["seq"],
                device="cpu", ckpt_dir=f"{tmp}/unsharded{i}"), None)
            want = {n: p.detach() for n, p in plain["state"].params.named_parameters()}
            got = res[str(i)]
            scalars = max(abs(a - b) / abs(b) for a, b in zip(
                got["losses"] + got["grad_norms"], plain["losses"] + plain["grad_norms"]))
            params = torch.load(Path(tmp, f"{i}.pt"))
            worst = max(float((params[n].detach() - w).norm() / w.norm().clamp_min(1e-30))
                        for n, w in want.items())
            emit({"phase": "shard", "part": "gloo_2x2", **case,
                  **{k: g[k] for k in ("steps", "batch", "seq", "rtol")},
                  "rules": got["rules"], "losses": got["losses"],
                  "unsharded_losses": plain["losses"], "scalars_max_rel": scalars,
                  "params_max_rel": worst, "wall_s": wall, "torch": _torch_version(),
                  "nvidia_smi": smi})
            if not (scalars <= g["rtol"] and worst <= g["rtol"]):
                raise AssertionError(f"shard gloo_2x2 {case}: losses and grad norms "
                                     f"{scalars}, params {worst} from the unsharded step "
                                     f"(rtol {g['rtol']})")


def shard_phase(torch, dev, reset, read, smi, baseline: dict) -> None:
    """The scale-out stack (module docstring, phase `shard`)."""
    shard_step(torch, dev, reset, read, smi, baseline)
    t0 = time.perf_counter()
    shard_gloo(smi)
    shard_dryrun(smi)
    emit({"phase": "shard", "part": "added_wall", "wall_s": time.perf_counter() - t0})


# -- the examples (slice 11) -------------------------------------------------------

# (module, arguments) of each ported example run on the card; boltzmann_mnist
# at 5 CD steps, as the verify recipe runs the JAX script
EXAMPLES = (("quickstart", ()), ("optimization_cal", ()), ("boltzmann_mnist", ("--steps", "5")),
            ("neural_decision", ()), ("serve_lm", ()), ("train_lm", ()))


def example_misses(name: str, out: dict) -> list:
    """The headline bounds tests/test_torch_examples.py holds each example
    to on the CPU that `out` (its main's return) misses."""
    if name == "quickstart":
        checks = {"ground states found": out["ground_states_found"], "tv < 0.03": out["tv"] < 0.03,
                  "hit rate 1": out["hit_rate"] == 1.0, "split-R-hat < 1.1": out["split_rhat"] < 1.1}
    elif name == "optimization_cal":
        # one chain's anneal ends in the C-A-L ground state or, at some
        # seeds, in a local minimum near 0.9 of its energy (|m| ~ 0.1 there)
        at_ground = out["energy"] == out["ground_state_energy"]
        checks = {"energy <= 0.85 of the ground state's":
                  out["energy"] <= 0.85 * out["ground_state_energy"],
                  "template agreement 1 at the ground state":
                  not at_ground or out["template_agreement"] == 1.0}
    elif name == "boltzmann_mnist":
        checks = {"data energy drops": out["data_energy"] < out["data_energy_init"],
                  "bottom-half agreement > 0.6": out["bottom_half_agreement"] > 0.6}
    elif name == "neural_decision":
        by_eta = out["by_eta"]
        checks = {"every trajectory commits": all(min(r["commit_distances"]) > 0
                                                  for r in by_eta.values()),
                  "eta 4 commits later": by_eta[4.0]["commit_median"] > by_eta[1.0]["commit_median"]}
    elif name == "train_lm":
        checks = {"the loss falls": out["last_loss"] < out["first_loss"]}
    else:
        checks = {"every token served": out["tokens"] == out["requests"] * 16}
    return [what for what, ok in checks.items() if not ok]


def examples_phase(torch, reset, read, smi) -> dict:
    """Each ported example's main once on the card (module docstring, phase
    `examples`): its headlines, wall and kernel launches. Returns the
    launches by example."""
    import contextlib
    import importlib
    import io

    import tempfile

    launches = {}
    for name, args in EXAMPLES:
        main = importlib.import_module(f"repro_torch.examples.{name}").main
        if name == "train_lm":  # a fresh checkpoint directory: it resumes from any
            tmp = tempfile.TemporaryDirectory()
            args = (*args, "--ckpt-dir", tmp.name)
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = main([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: c for k, c in read().items() if c}
        out.pop("completions", None)
        emit({"phase": "examples", "example": name, "args": list(args), "wall_s": wall,
              "headline": out, "launches": launches[name],
              "last_line": printed.getvalue().strip().splitlines()[-1], "nvidia_smi": smi})
        if name == "train_lm":
            tmp.cleanup()
        misses = example_misses(name, out)
        if misses:
            raise AssertionError(f"example {name}: misses {misses}: {out}")
    return launches


def train_gates(torch, np) -> int:
    """The train phase's calibration on the card: every number its gates
    read (the full-width losses, the card against the CPU, the resume's
    difference), with no gate held."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    reset, read = counters()
    train_phase(torch, np, torch.device("cuda", 0), reset, read, smi, hold=False)
    return 0


def serve_gates(device: str, archs=()) -> int:
    """The serve gates' calibration: each SERVE_MODELS config with an
    attention layer (those named in `archs`, if any), in bf16, its greedy
    run with the plain attention (and recurrentgemma's long request) held
    against three emulations of it: every output moved by up to one bf16
    ulp of the f32 result (what the kernel's contract allows), a thousandth
    of the outputs moved by one ulp, and the heads' outputs rolled by one (a
    wrong head map). Every call of the attention's plain version is
    emulated: the prefill's self-attention, and an encoder-decoder's encoder
    and cross-attention (decode runs no kernel). On the card at full width;
    on the CPU at full depth, narrowed (SERVE_NARROW)."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import model, transformer

    dev = torch.device(device)
    plain = ref.flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(1)

    def ulp_of(o):
        return 2.0 ** (torch.floor(torch.log2(o.abs().clamp_min(1e-30))) - 7)

    calls = {}  # the emulated calls by kind: "causal" (self-attention), "kv_len" (bounded)

    def count(causal, kv_len):
        kind = "causal" if causal else "kv_len" if kv_len is not None else "full"
        calls[kind] = calls.get(kind, 0) + 1

    def within_an_ulp(q, k, v, causal=True, window=0, kv_len=None):
        count(causal, kv_len)
        o = plain(q.float(), k.float(), v.float(), causal, window, kv_len)
        u = torch.rand(o.shape, generator=gen, device=dev)
        return (o + (2 * u - 1) * ulp_of(o)).to(q.dtype)

    def a_thousandth(q, k, v, causal=True, window=0, kv_len=None):
        count(causal, kv_len)
        o = plain(q.float(), k.float(), v.float(), causal, window, kv_len)
        moved = torch.rand(o.shape, generator=gen, device=dev) < 1e-3
        return torch.where(moved, o + ulp_of(o), o).to(q.dtype)

    def heads_rolled(q, k, v, causal=True, window=0, kv_len=None):
        count(causal, kv_len)
        return plain(q, k, v, causal, window, kv_len).roll(1, dims=0)

    reset, read = counters()
    for arch, n_requests in SERVE_MODELS:
        if archs and arch not in archs:
            continue
        cfg = get_config(arch)
        if not any(kind in transformer.ATTENTION_KINDS for kind in transformer.layer_kinds(cfg)):
            continue  # no attention: nothing to emulate
        if dev.type == "cpu":
            narrow = dict(SERVE_NARROW[arch])
            if cfg.moe:
                narrow["moe"] = dataclasses.replace(cfg.moe, d_expert=narrow["d_ff"])
            cfg = dataclasses.replace(cfg, **narrow)
        params = model.init_params(cfg, 0, device=dev)
        cases = [("", serve_requests(np, cfg, n_requests), serve_max_len(cfg))]
        if arch in SERVE_LONG:
            length, long_len = SERVE_LONG[arch]
            cases.append(("long_", long_request(np, cfg, length), long_len))
        out = {}
        for prefix, requests, max_len in cases:
            base = greedy_runs(cfg, params, requests, max_len, ["reference"], reset, read)
            for name, fn in (("within_one_ulp", within_an_ulp), ("a_thousandth", a_thousandth),
                             ("heads_rolled", heads_rolled)):
                calls.clear()
                with mock.patch.object(ref, "flash_attention_ref", fn):
                    emulated = greedy_runs(cfg, params, requests, max_len, ["reference"], reset,
                                           read)
                gate = serve_gate(emulated["reference"], base["reference"],
                                  SERVE_MARGIN[cfg.family])
                out[prefix + name] = dict(gate, tokens_flipped=len(gate["tokens_flipped"]),
                                          emulated_calls=dict(calls))
            del base, emulated
        del params
        emit({"phase": "serve_gates", "device": str(dev), "arch": arch, "family": cfg.family,
              "narrowed": SERVE_NARROW[arch] if dev.type == "cpu" else None,
              "n_layers": cfg.n_layers, "requests": n_requests,
              "tol": SERVE_LOGITS_RTOL[cfg.family], **out})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def cut_fraction(prob, s):
    """Fraction of a unit-weight MaxCut instance's edges cut by each state."""
    n_edges = float(prob.deg.sum()) / 2
    return (n_edges - prob.energy(s)) / (2 * n_edges)


def energy_launches(steps: int, sample_every: int, first_hit, passes: int = 2) -> int:
    """The energy kernel's launches (the sparse energy's under ColoredGibbs,
    the lattice energy's under ChromaticGibbs) in `passes` passes of a run()
    on the cuda backend: the first state's, one a step with first_hit, and
    one over the recorded samples."""
    samples = bool(sample_every) and steps // sample_every > 0
    return passes * (1 + (steps if first_hit is not None else 0) + samples)


def gibbs_runs(prob, kernel, runs, reset, read, *, n_chains, n_sweeps, sample_every,
               timeit=True):
    """Drive run() once per (label, backend, first_hit) of `runs` with
    geometric(0.3, 3.0) annealing; launch counters zeroed before each run
    and read after it."""
    import torch
    from repro_torch.core.sampler_api import geometric, run

    out = {}
    for label, backend, first_hit in runs:
        reset()
        res = run(prob, kernel, 0, n_steps=n_sweeps, n_chains=n_chains,
                  schedule=geometric(0.3, 3.0), sample_every=sample_every,
                  first_hit=first_hit, backend=backend, timeit=timeit)
        launches = read()
        e_final = prob.energy(res.s)
        if not bool(torch.isfinite(res.energies).all()) or not bool(torch.isfinite(e_final).all()):
            raise AssertionError(f"{label}: non-finite energies")
        rate = res.timing.chain_steps_per_s if timeit else None
        out[label] = {
            "backend": backend, "first_hit": first_hit, "launches": launches,
            "chain_sweeps_per_s": rate, "spin_updates_per_s": rate and rate * prob.n,
            "wall_s": res.timing.wall_s if timeit else None,
            "compile_s": res.timing.compile_s if timeit else None,
            "hit_fraction": None if res.hit is None else float(res.hit.float().mean()),
            "final_energy_per_spin": float(e_final.mean()) / prob.n,
            "final_state": res.s,
        }
    return out


def clamped_conditional(prob, backend, n_chains, n_sweeps):
    """CAL with its top half clamped to the template (Fig. 4C): whether the
    clamped half was preserved exactly, and the free half's mean agreement
    with the template."""
    import dataclasses

    import torch
    from repro_torch.core import problems
    from repro_torch.core.sampler_api import ChromaticGibbs, run

    H, W = prob.shape
    template = torch.as_tensor(problems.cal_template(), device=prob.device)
    known = torch.zeros((H, W), dtype=torch.bool, device=prob.device)
    known[: H // 2] = True
    clamped = dataclasses.replace(prob, clamp_mask=known, clamp_value=template)
    res = run(clamped, ChromaticGibbs(), 1, n_steps=n_sweeps, n_chains=n_chains, backend=backend)
    exact = bool((res.s[:, : H // 2] == template[: H // 2]).all())
    agree = float((res.s[:, H // 2:] * template[H // 2:]).mean())
    return exact, agree


def cpu_gates() -> int:
    """The lattice and sparse main paths with backend="ref" on the CPU at 256
    chains: the numbers the card's gates were calibrated from."""
    import torch
    from repro_torch.core import problems
    from repro_torch.core.sampler_api import ChromaticGibbs, ColoredGibbs

    reset, read = counters()
    cal = problems.cal_problem(device="cpu")
    e_t = float(cal.energy(torch.as_tensor(problems.cal_template())))
    kw = dict(LATTICE_MAIN, n_chains=256, timeit=False)
    lat = gibbs_runs(cal, ChromaticGibbs(), [("ref_first_hit", "ref", e_t)], reset, read, **kw)
    exact, agree = clamped_conditional(problems.cal_problem(coupling=0.6, device="cpu"),
                                       "ref", 256, 400)
    for m in lat.values():
        del m["final_state"]
    emit({"phase": "cpu_gates_lattice", "problem": "cal_problem()", "n_chains": 256,
          "runs": lat, "clamped_half_exact": exact, "free_half_agreement": agree})
    mc = problems.random_3regular_maxcut(SPARSE_MAIN["n"], 0, device="cpu")
    kw = dict(SPARSE_MAIN, n_chains=256, timeit=False)
    del kw["n"]
    sp = gibbs_runs(mc, ColoredGibbs(), [("ref_first_hit", "ref", sparse_target(mc))],
                    reset, read, **kw)
    for m in sp.values():
        m["cut_fraction"] = float(cut_fraction(mc, m.pop("final_state")).mean())
    emit({"phase": "cpu_gates_sparse", "problem": f"random_3regular_maxcut({mc.n}, 0)",
          "n_chains": 256, "runs": sp})
    return 0


def sparse_csr(torch, prob):
    """The (n, n) CSR coupling matrix of a SparseIsing, padded slots dropped:
    torch.sparse.mm(csr, s.T) is the fields without b (timed only)."""
    n, D = prob.n, prob.max_deg
    live = torch.arange(D, device=prob.device)[None, :] < prob.deg[:, None]
    rows = torch.arange(n, device=prob.device)[:, None].expand(n, D)[live]
    return torch.sparse_coo_tensor(torch.stack([rows, prob.nbr_idx[live].long()]),
                                   prob.nbr_w[live], (n, n)).coalesce().to_sparse_csr()


def sparse_target(prob) -> float:
    """first_hit energy of a unit-weight MaxCut instance: a cut of CUT_MIN
    of its edges."""
    n_edges = float(prob.deg.sum()) / 2
    return n_edges * (1.0 - 2.0 * CUT_MIN)


# The long-row colour sweep (rows of n > 116224 sites): the 3D +-J EA glass
# at Janus's L = 80 under its two parity classes, 64 chains (the benchmark's
# ea3d80.aging), and a random 3-regular graph past the shared-memory kernel's
# rows under its greedy colouring; run()'s graphed sweeps at L = 80.
LONG_EA = dict(L=80, n_chains=64)
LONG_3REGULAR = dict(n=131072, n_chains=16)
# ragged: n % 4 = 2 (no 16-byte rows), 5 chains (padded to 16), the tables
# padded to 8 slots (plan rows of 12 columns, read through the cache)
LONG_RAGGED = dict(n=116230, n_chains=5, slots=8)
LONG_RUN = dict(n_chains=64, n_steps=60, sample_every=20, beta=1.4285714)


def ea3d_problem(torch, L: int, seed: int, dev):
    """The periodic L^3 cubic lattice with +-1 couplings from `seed` (one a
    +x, +y, +z edge of each site, the same both ways), each site's six
    neighbours in ascending slots, and its two parity classes."""
    from repro_torch.core.sparse import SparseIsing

    n = L**3
    z, y, x = (a.flatten() for a in torch.meshgrid(*(torch.arange(L, device=dev),) * 3,
                                                    indexing="ij"))

    def site(x, y, z):
        return x % L + L * ((y % L) + L * (z % L))

    up = torch.stack([site(x + 1, y, z), site(x, y + 1, z), site(x, y, z + 1)], 1)
    down = torch.stack([site(x - 1, y, z), site(x, y - 1, z), site(x, y, z - 1)], 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    j_up = torch.where(torch.rand((n, 3), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    j_down = j_up[down, torch.arange(3, device=dev)]
    idx = torch.cat([up, down], 1)
    order = idx.argsort(1)
    parity = (x + y + z) % 2
    return SparseIsing(nbr_idx=idx.gather(1, order).to(torch.int32),
                       nbr_w=torch.cat([j_up, j_down], 1).gather(1, order).contiguous(),
                       deg=torch.full((n,), 6, dtype=torch.int32, device=dev),
                       b=torch.zeros(n, device=dev), color_masks=torch.stack([parity == 0,
                                                                              parity == 1]))


def long_sweep_phase(torch, np, dev, reset, read, smi) -> dict:
    """The long-row sweep against its plain version bit for bit (three
    chained sweeps at each graph, per-row beta), the graphed
    ColoredGibbs run at L = 80 against its plain backend on the card, then
    the kernel's time at (64, 512000) beside its bound, its sector floor
    and its plain version. Returns the kernels line's entry."""
    from repro_torch.core import problems
    from repro_torch.core.sampler_api import ColoredGibbs, constant, run
    from repro_torch.kernels import ops, sparse_gather

    ragged = problems.random_3regular_maxcut(LONG_RAGGED["n"], 4, device=dev)
    pads = LONG_RAGGED["slots"] - ragged.max_deg
    own = torch.arange(ragged.n, dtype=torch.int32, device=dev)[:, None].repeat(1, pads)
    ragged = dataclasses.replace(
        ragged, nbr_idx=torch.cat([ragged.nbr_idx, own], 1).contiguous(),
        nbr_w=torch.cat([ragged.nbr_w, torch.zeros(own.shape, device=dev)], 1).contiguous())
    cases = [("ea3d", ea3d_problem(torch, LONG_EA["L"], 1, dev), LONG_EA["n_chains"]),
             ("3regular", problems.random_3regular_maxcut(LONG_3REGULAR["n"], 3, device=dev),
              LONG_3REGULAR["n_chains"]),
             ("3regular_ragged", ragged, LONG_RAGGED["n_chains"])]
    mism, max_err = 0, 0.0
    for graph, prob, B in cases:
        n = prob.n
        if sparse_gather.sweep_kernel(n) != "colored_gibbs_sweep_long":
            raise AssertionError(f"long_sweep: n = {n} does not take the long-row kernel")
        masks = prob.color_masks.float()
        plan = sparse_gather.colour_plan(prob.nbr_idx, prob.nbr_w, prob.b, masks)
        if not plan.independent:
            raise AssertionError(f"long_sweep: the {graph} colouring is not independent sets")
        gen = torch.Generator(device=dev).manual_seed(n)
        s = torch.where(torch.rand((B, n), generator=gen, device=dev) < 0.5, 1.0, -1.0)
        beta = 0.3 + 2.7 * torch.rand((B,), generator=gen, device=dev)
        got = want = s
        reset()
        for _ in range(3):
            u = torch.rand((masks.shape[0], B, n), generator=gen, device=dev)
            got = sparse_gather.colored_gibbs_sweep(got, prob.nbr_idx, prob.nbr_w, prob.b, u,
                                                    masks, beta, plan=plan)
            want = ops.colored_gibbs_sweep(want, prob.nbr_idx, prob.nbr_w, prob.b, u, masks,
                                           beta, mode="reference")
        torch.cuda.synchronize()
        launches = read()
        differ = int((got != want).sum())
        case_err = float((got - want).abs().max())
        if differ or launches["colored_gibbs_sweep_long"] != 3 or launches["colored_gibbs_sweep"]:
            raise AssertionError(f"long_sweep ({B},{n},{graph}): {differ} spins differ from the "
                                 f"plain version, launches {launches}")
        mism += differ
        max_err = max(max_err, case_err)
        emit({"phase": "check_long_sweep", "B": B, "n": n, "graph": graph,
              "max_deg": prob.max_deg, "colors": len(plan.counts), "counts": list(plan.counts),
              "sweeps": 3, "mismatches": differ, "max_abs_err": case_err})

    # the main path: run() graphs the sweep's C + 2 launches and its
    # scratch; the same run on the plain backend, on the card, bit for bit
    ea = cases[0][1]
    kw = dict(n_steps=LONG_RUN["n_steps"], n_chains=LONG_RUN["n_chains"],
              sample_every=LONG_RUN["sample_every"], schedule=constant(LONG_RUN["beta"]))
    reset()
    res_k = run(ea, ColoredGibbs(), 2147483907, backend="cuda", **kw)
    run_launches = read()
    res_r = run(ea, ColoredGibbs(), 2147483907, backend="ref", **kw)
    run_differ = {k: int((getattr(res_k, k) != getattr(res_r, k)).sum())
                  for k in ("s", "samples", "energies")}
    run_err = max(float((getattr(res_k, k) - getattr(res_r, k)).abs().max())
                  for k in ("s", "samples"))
    max_err = max(max_err, run_err)
    if any(run_differ.values()) or run_launches["colored_gibbs_sweep_long"] != kw["n_steps"]:
        raise AssertionError(f"long_sweep run(): {run_differ} differ between the cuda and the "
                             f"plain backend, launches {run_launches}")
    emit({"phase": "long_sweep_run", "problem": f"ea3d L={LONG_EA['L']}", **LONG_RUN,
          "mismatches": run_differ, "max_abs_err": run_err,
          "launches": run_launches["colored_gibbs_sweep_long"]})

    B, n, D = LONG_EA["n_chains"], ea.n, ea.max_deg
    masks = ea.color_masks.float()
    C = masks.shape[0]
    plan = sparse_gather.colour_plan(ea.nbr_idx, ea.nbr_w, ea.b, masks)
    s = torch.where(torch.rand((B, n), device=dev) < 0.5, 1.0, -1.0)
    u = torch.rand((C, B, n), device=dev)
    beta = torch.full((B,), LONG_RUN["beta"], dtype=torch.float32, device=dev)
    tables = (ea.nbr_idx, ea.nbr_w, ea.b)
    ms = {"colored_gibbs_sweep_long": time_ms(torch, lambda: sparse_gather.colored_gibbs_sweep(
              s, *tables, u, masks, beta, plan=plan)),
          "colored_gibbs_sweep_long_plain": time_ms(torch, lambda: ops.colored_gibbs_sweep(
              s, *tables, u, masks, beta, mode="reference"), n=10, warmup=2),
          "uniforms": time_ms(torch, lambda: torch.rand((C, B, n), device=dev))}
    updated = float(masks.sum())
    bound_ms, bound_by = bound(4 * (2 * B * n + B * updated + 2 * n * D + n + C * n + B),
                               B * updated * (2 * D + 6), FP32_OPS_PER_S)
    u_sectors = sum(int(torch.unique(plan.sites[a:z] // 8).numel())
                    for a, z in zip(plan.offsets[:-1].tolist(), plan.offsets[1:].tolist()))
    plan_bytes = sum(x.numel() * x.element_size() for x in (plan.offsets, plan.idx, plan.w))
    floor_ms = (4 * 2 * B * n + 32 * B * u_sectors + plan_bytes + 4 * B) / HBM_BYTES_PER_S * 1e3
    emit({"phase": "timing_long_sweep", "shape": [B, n], "max_deg": D, "colors": C,
          "ms": ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "sector_floor_ms": floor_ms, "nvidia_smi": smi})
    return {"name": "colored_gibbs_sweep_long", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/colored_gibbs_long.cu",
            "replaces": "src/repro/kernels/sparse_gather.py:126",
            "launches": run_launches["colored_gibbs_sweep_long"], "max_abs_err": max_err,
            "mismatches": mism, "ms": ms["colored_gibbs_sweep_long"],
            "plain_ms": ms["colored_gibbs_sweep_long_plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": [B, n],
            "sector_floor_ms": floor_ms}


# The sparse energy (csrc/sparse_energy.cu). Its terms are SparseIsing.energy's
# bit for bit and only the order of the sum over the sites differs, so on +-1
# states with +-1 couplings it is exact, and otherwise within the bound of any
# two orders of n - 1 rounded adds: ENERGY_EPS * n * (0.5 sum|s h| + sum|b s|)
# + ENERGY_EPS |E| (the halving is exact; the last add rounds once more).
ENERGY_EPS = 2.0**-23
ENERGY_TIMING = ((256, 16384), (320, 512000))  # (rows, n): maxcut3r16k's sweep, ea3d80's
ENERGY_RUN = dict(n_chains=64, n_steps=200, sample_every=50)


def energy_band(torch, s, idx, w, b):
    """The widest |E_kernel - E_plain| two sum orders allow (ENERGY_EPS);
    per-sample (S, n, D) couplings w give row r of s's leading axis sample
    r // (B / S)'s."""
    s64 = s.double()
    if w.ndim == 3:
        w = w.double().repeat_interleave(s.shape[0] // w.shape[0], 0).view(
            (s.shape[0],) + (1,) * (s.ndim - 2) + tuple(w.shape[1:]))
    h = torch.zeros_like(s64)
    for k in range(idx.shape[1]):
        h = h + w[..., k].double() * s64.index_select(-1, idx[:, k])
    n = s.shape[-1]
    terms = 0.5 * (s64 * h).abs().sum(-1) + (b.double() * s64).abs().sum(-1)
    e = (0.5 * (s64 * h).sum(-1) + (b.double() * s64).sum(-1)).abs()
    return ENERGY_EPS * (n * terms + e)


def ring(torch, n: int, dev):
    """A ring of n sites with +-1 couplings from n (each edge's the same
    both ways) and a pad slot."""
    i = torch.arange(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    j = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5, 1.0, -1.0)  # edge (i, i+1)
    idx = torch.stack([(i - 1) % n, (i + 1) % n, i], 1).to(torch.int32)
    w = torch.stack([j[(i - 1) % n], j, torch.zeros(n, device=dev)], 1).contiguous()
    return idx, w, torch.zeros(n, device=dev)


def sparse_energy_phase(torch, np, dev, reset, read, smi) -> list:
    """The sparse energy's two routes against the plain version, graphed
    run()s with first_hit against the plain backend, and the kernels'
    times beside their bounds and the plain version. Returns the kernels
    line's two entries."""
    from repro_torch.core import problems
    from repro_torch.core.sampler_api import ColoredGibbs, constant, geometric, run
    from repro_torch.kernels import ops, sparse_gather

    rng = np.random.default_rng(31)
    ea80 = ea3d_problem(torch, 80, 1, dev)
    ea50 = ea3d_problem(torch, 50, 2, dev)
    ragged = problems.random_3regular_maxcut(LONG_RAGGED["n"], 4, device=dev)
    pads = LONG_RAGGED["slots"] - ragged.max_deg
    own = torch.arange(ragged.n, dtype=torch.int32, device=dev)[:, None].repeat(1, pads)
    ragged_tables = (torch.cat([ragged.nbr_idx, own], 1).contiguous(),
                     torch.cat([ragged.nbr_w, torch.zeros(own.shape, device=dev)], 1).contiguous(),
                     ragged.b)

    def tables(p):
        return p.nbr_idx, p.nbr_w, p.b

    def pm1(shape):
        return torch.where(torch.rand(shape, device=dev) < 0.5, 1.0, -1.0)

    def gaussian(idx, n_rows_shape, scale=0.7):
        """Gaussian couplings on idx's slots (pads kept at 0), a Gaussian
        bias and Gaussian states."""
        n, D = idx.shape
        w = torch.randn((n, D), device=dev) * scale * (idx != torch.arange(
            n, device=dev, dtype=torch.int32)[:, None])
        return torch.randn(n_rows_shape, device=dev), (idx, w.contiguous(),
                                                      0.3 * torch.randn(n, device=dev))

    mc = {n: problems.random_3regular_maxcut(n, seed, device=dev)
          for n, seed in ((16384, 0), (40000, 1), (4096, 3))}
    cases = [  # (label, s, tables, exact)
        ("3regular", pm1((256, 16384)), tables(mc[16384]), True),
        ("3regular", pm1((298, 4096)), tables(mc[4096]), True),
        ("3regular", pm1((2, 40000)), tables(mc[40000]), True),
        ("3regular_samples", pm1((4, 3, 4096)), tables(mc[4096]), True),
        ("ring", pm1((2, 58112)), ring(torch, 58112, dev), True),
        ("ea3d", pm1((320, ea80.n)), tables(ea80), True),
        ("ea3d_samples", pm1((64, 5, ea50.n)), tables(ea50), True),
        ("ring", pm1((3, 58113)), ring(torch, 58113, dev), True),
        ("3regular_ragged", pm1((5, ragged.n)), ragged_tables, True),
        ("3regular_gaussian", *gaussian(mc[16384].nbr_idx, (256, 16384)), False),
        ("ea3d_gaussian", *gaussian(ea50.nbr_idx, (3, ea50.n)), False),
        ("dense_gaussian", *gaussian(torch.as_tensor(rng.integers(0, 5, (5, 4)).astype(np.int32),
                                                     device=dev), (1, 5)), False),
    ]
    err = {"sparse_energy": 0.0, "sparse_energy_long": 0.0}
    mism = dict.fromkeys(err, 0)
    for label, s, tabs, exact in cases:
        n = s.shape[-1]
        route = sparse_gather.energy_kernel(n)
        reset()
        got = sparse_gather.sparse_energy(s, *tabs)
        launches = read()
        want = ops.sparse_energy(s, *tabs, mode="reference")
        torch.cuda.synchronize()
        if launches != dict(dict.fromkeys(launches, 0), **{route: 1}):
            raise AssertionError(f"sparse_energy {label} {tuple(s.shape)}: launched {launches}, "
                                 f"expected one {route}")
        order = sparse_gather.energy_in_kernel_order(s, *tabs)
        differ = int((got != want).sum())
        off_order = int((got != order).sum())
        case_err = float((got - want).abs().max())
        band = energy_band(torch, s, *tabs)
        outside = int(((got.double() - want.double()).abs() > band).sum())
        if (exact and differ) or off_order or outside or got.shape != want.shape:
            raise AssertionError(f"sparse_energy {label} {tuple(s.shape)}: {differ} energies "
                                 f"differ from the plain version, {off_order} from the "
                                 f"kernel's order, {outside} outside the band, max |dE| "
                                 f"{case_err}")
        err[route] = max(err[route], case_err)
        mism[route] += differ
        emit({"phase": "check_sparse_energy", "graph": label, "shape": list(s.shape),
              "max_deg": tabs[0].shape[1], "route": route, "exact": exact, "mismatches": differ,
              "order_mismatches": off_order, "max_abs_err": case_err,
              "band_max": float(band.max())})
        del order
    del cases

    # run() on both routes, graphed, against the plain backend on the card
    runs, run_launches = {}, {}
    for label, prob, schedule, target in (
            ("maxcut3r", mc[16384], geometric(0.3, 3.0), sparse_target(mc[16384])),
            ("ea3d_l50", ea50, constant(LONG_RUN["beta"]), -1.5 * ea50.n)):
        reset()
        res_k = run(prob, ColoredGibbs(), 2147483931, backend="cuda", schedule=schedule,
                    first_hit=target, **ENERGY_RUN)
        torch.cuda.synchronize()
        launches = read()
        res_r = run(prob, ColoredGibbs(), 2147483931, backend="ref", schedule=schedule,
                    first_hit=target, **ENERGY_RUN)
        differ = {k: int((getattr(res_k, k) != getattr(res_r, k)).sum())
                  for k in ("s", "samples", "energies", "hit", "t_hit")}
        route = sparse_gather.energy_kernel(prob.n)
        want_energy = 1 + ENERGY_RUN["n_steps"] + 1  # e0, a step each, the samples
        if any(differ.values()) or launches[route] != want_energy:
            raise AssertionError(f"sparse_energy run() {label}: {differ} differ between the "
                                 f"cuda and the plain backend, launches {launches}")
        run_launches[route] = launches[route]
        runs[label] = {"n": prob.n, "route": route, "mismatches": differ,
                       "energy_launches": launches[route],
                       "hit_fraction": float(res_k.hit.float().mean())}
    emit({"phase": "sparse_energy_run", **ENERGY_RUN, "first_hit": True, "runs": runs})

    ms, bounds, shapes = {}, {}, {}
    for (B, n), prob in zip(ENERGY_TIMING, (mc[16384], ea80)):
        route = sparse_gather.energy_kernel(n)
        D = prob.max_deg
        s = pm1((B, n))
        ms[route] = time_ms(torch, lambda: sparse_gather.sparse_energy(s, *tables(prob)))
        ms[route + "_plain"] = time_ms(torch, lambda: ops.sparse_energy(
            s, *tables(prob), mode="reference"), n=20 if n < 100000 else 10, warmup=2)
        bounds[route] = bound(4 * (B * n + n * (2 * D + 1) + B), B * n * (2 * D + 4),
                              FP32_OPS_PER_S)
        shapes[route] = [B, n, D]
    emit({"phase": "timing_sparse_energy", "shapes": shapes, "ms": ms,
          "bound_ms": {k: v[0] for k, v in bounds.items()},
          "bound_by": {k: v[1] for k, v in bounds.items()},
          "rows_per_block": sparse_gather.fields_rows(*ENERGY_TIMING[0],
                                                      sparse_gather._sm_count(dev)),
          "nvidia_smi": smi})
    source = "src/repro_torch/kernels/csrc/sparse_energy.cu"
    return [{"name": route, "route": "cuda", "source": source, "replaces": None,
             "launches": run_launches[route], "max_abs_err": err[route], "mismatches": mism[route],
             "ms": ms[route], "plain_ms": ms[route + "_plain"], "bound_ms": bounds[route][0], "bound_by": bounds[route][1], "library_ms": None,
             "shape": shapes[route]} for route in ("sparse_energy", "sparse_energy_long")]


# Disorder samples (per-sample couplings over one neighbour table): the
# per-sample sweep (csrc/colored_gibbs.cu, colored_gibbs_samples_kernel) and
# energy (csrc/sparse_energy.cu, sparse_energy_samples) at ea3d32.samples'
# shape, 128 samples x 4 replicas of the L = 32 lattice, and on graphs with
# Gaussian per-sample couplings whose plan rows are of 4 and of more than 8.
SAMPLES_EA = dict(L=32, samples=128, replicas=4)
SAMPLES_RUN = dict(n_steps=60, sample_every=20, beta=1.4285714)


def ea3d_samples_problem(torch, L: int, S: int, seed: int, dev):
    """`ea3d_problem`'s lattice with S samples' +-1 couplings from `seed`,
    (S, n, 6), each edge's the same both ways in every sample."""
    one = ea3d_problem(torch, L, seed, dev)
    n = one.n
    z, y, x = (a.flatten() for a in torch.meshgrid(*(torch.arange(L, device=dev),) * 3,
                                                    indexing="ij"))
    down = torch.stack([(x - 1) % L + L * (y + L * z), x + L * ((y - 1) % L + L * z),
                        x + L * (y + L * ((z - 1) % L))], 1)
    up = torch.stack([(x + 1) % L + L * (y + L * z), x + L * ((y + 1) % L + L * z),
                      x + L * (y + L * ((z + 1) % L))], 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    j_up = torch.where(torch.rand((S, n, 3), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    j_down = j_up[:, down, torch.arange(3, device=dev)]
    order = torch.cat([up, down], 1).argsort(1)
    w = torch.cat([j_up, j_down], 2).gather(2, order.expand(S, n, 6)).contiguous()
    return dataclasses.replace(one, nbr_w=w)


def gaussian_samples(torch, prob, S: int):
    """S samples of symmetric non-integer couplings on `prob`'s table: slot
    (i, j) of sample k carries sin(0.001 key(i, j) + k), key the same both
    ways; pads 0."""
    idx = prob.nbr_idx.long()
    i = torch.arange(prob.n, device=idx.device)[:, None].expand_as(idx)
    key = ((i + idx) * 7919 + (i * idx) % 104729).float()
    live = idx != i
    k = torch.arange(S, device=idx.device, dtype=torch.float32)[:, None, None]
    return dataclasses.replace(prob, nbr_w=(torch.sin(0.001 * key + k) * live).contiguous())


def samples_phase(torch, np, dev, reset, read, smi) -> list:
    """The per-sample sweep and energy against their plain versions (bit for
    bit: three chained sweeps, per-row beta; the energy exactly on +-1
    couplings and in its own order on Gaussian ones), the graphed run() at
    the cell's shape against the plain backend and against one-table runs
    of S identical samples, then both kernels' times beside their bounds,
    the plain versions and the one-table sweep. Returns the kernels line's
    two entries."""
    from repro_torch.core import problems
    from repro_torch.core.ising import DenseIsing
    from repro_torch.core.sampler_api import ColoredGibbs, constant, run
    from repro_torch.core.sparse import SparseIsing
    from repro_torch.kernels import ops, sparse_gather

    L, S, R = SAMPLES_EA["L"], SAMPLES_EA["samples"], SAMPLES_EA["replicas"]
    ea = ea3d_samples_problem(torch, L, S, 34, dev)
    ea.validate()
    mc = gaussian_samples(torch, problems.random_3regular_maxcut(4096, 5, device=dev), 3)
    rng = np.random.default_rng(34)  # a dense 40-site graph: D > 7, plan rows read as scalars
    A = rng.normal(0, 0.6, (40, 40)) * (rng.random((40, 40)) < 0.4)
    dense = gaussian_samples(torch, SparseIsing.from_dense(DenseIsing.from_numpy(
        np.triu(A, 1) + np.triu(A, 1).T, rng.normal(0, 0.3, 40), device=dev)), 2)
    mism = {"colored_gibbs_sweep_samples": 0, "sparse_energy_samples": 0}
    err = dict.fromkeys(mism, 0.0)
    for graph, prob, B in (("ea3d32", ea, S * R), ("3regular_gaussian", mc, 6),
                           ("dense40_gaussian", dense, 4)):
        n, masks = prob.n, prob.color_masks.float()
        plan = sparse_gather.colour_plan(prob.nbr_idx, prob.nbr_w, prob.b, masks)
        gen = torch.Generator(device=dev).manual_seed(n)
        s = torch.where(torch.rand((B, n), generator=gen, device=dev) < 0.5, 1.0, -1.0)
        beta = 0.3 + 2.7 * torch.rand((B,), generator=gen, device=dev)
        got = want = s
        tables = (prob.nbr_idx, prob.nbr_w, prob.b)
        reset()
        for _ in range(3):
            u = torch.rand((masks.shape[0], B, n), generator=gen, device=dev)
            got = sparse_gather.colored_gibbs_sweep(got, *tables, u, masks, beta, plan=plan)
            want = ops.colored_gibbs_sweep(want, *tables, u, masks, beta, mode="reference")
        torch.cuda.synchronize()
        launches = read()
        differ = int((got != want).sum())
        if differ or launches != dict(dict.fromkeys(launches, 0), colored_gibbs_sweep_samples=3):
            raise AssertionError(f"samples sweep ({B},{n},{graph}): {differ} spins differ from "
                                 f"the plain version, launches {launches}")
        mism["colored_gibbs_sweep_samples"] += differ
        err["colored_gibbs_sweep_samples"] = max(err["colored_gibbs_sweep_samples"],
                                                 float((got - want).abs().max()))
        exact = graph == "ea3d32"
        for states in (got, torch.stack([got, want, -got], 1), torch.randn((B, n), device=dev)):
            reset()
            e = sparse_gather.sparse_energy(states.contiguous(), *tables)
            launches = read()
            e_plain = ops.sparse_energy(states, *tables, mode="reference")
            e_order = sparse_gather.energy_in_kernel_order(states, *tables)
            off_plain = int((e != e_plain).sum())
            off_order = int((e != e_order).sum())
            gap = (e.double() - e_plain.double()).abs()
            band = energy_band(torch, states, *tables)
            outside = int((gap > band).sum())
            pm1 = exact and bool((states.abs() == 1).all())  # +-1 states, +-1 couplings
            if (off_order or (pm1 and off_plain) or outside
                    or launches != dict(dict.fromkeys(launches, 0), sparse_energy_samples=1)):
                raise AssertionError(f"samples energy {graph} {tuple(states.shape)}: {off_plain} "
                                     f"differ from the plain version, {off_order} from the "
                                     f"kernel's order, {outside} outside the band, launches "
                                     f"{launches}")
            mism["sparse_energy_samples"] += off_plain
            err["sparse_energy_samples"] = max(err["sparse_energy_samples"], float(gap.max()))
            emit({"phase": "check_samples_energy", "graph": graph, "shape": list(states.shape),
                  "samples": prob.n_samples, "exact": pm1, "order_mismatches": off_order,
                  "plain_mismatches": off_plain, "max_abs_err": float(gap.max()),
                  "band_max": float(band.max())})
            del band, gap
        emit({"phase": "check_samples_sweep", "graph": graph, "B": B, "n": n,
              "samples": prob.n_samples, "max_deg": prob.max_deg, "plan_cols": plan.idx.shape[1],
              "colors": len(plan.counts), "sweeps": 3, "mismatches": differ,
              "max_abs_err": float((got - want).abs().max())})

    # run() at the cell's shape: graphed cuda against the plain backend, and
    # S identical samples against the one-table problem
    kw = dict(n_steps=SAMPLES_RUN["n_steps"], n_chains=S * R,
              sample_every=SAMPLES_RUN["sample_every"], schedule=constant(SAMPLES_RUN["beta"]))
    reset()
    res_k = run(ea, ColoredGibbs(), 2147483934, backend="cuda", **kw)
    torch.cuda.synchronize()
    run_launches = read()
    res_r = run(ea, ColoredGibbs(), 2147483934, backend="ref", **kw)
    first = dataclasses.replace(ea, nbr_w=ea.nbr_w[0].contiguous())
    same = dataclasses.replace(ea, nbr_w=first.nbr_w.expand(S, *first.nbr_w.shape).contiguous())
    res_one = run(first, ColoredGibbs(), 2147483935, backend="cuda", **kw)
    res_same = run(same, ColoredGibbs(), 2147483935, backend="cuda", **kw)
    fields = ("s", "samples", "energies")
    differ = {k: int((getattr(res_k, k) != getattr(res_r, k)).sum()) for k in fields}
    differ_same = {k: int((getattr(res_one, k) != getattr(res_same, k)).sum()) for k in fields}
    want_launches = dict(dict.fromkeys(run_launches, 0),
                         colored_gibbs_sweep_samples=kw["n_steps"], sparse_energy_samples=2)
    if any(differ.values()) or any(differ_same.values()) or run_launches != want_launches:
        raise AssertionError(f"samples run(): {differ} differ from the plain backend, "
                             f"{differ_same} identical samples from one table, launches "
                             f"{run_launches}")
    emit({"phase": "samples_run", "problem": f"ea3d L={L}", "samples": S, "replicas": R,
          **SAMPLES_RUN, "mismatches": differ, "identical_samples_mismatches": differ_same,
          "launches": {k: v for k, v in run_launches.items() if v}})
    del res_k, res_r, res_one, res_same, same

    B, n, D = S * R, ea.n, ea.max_deg
    masks = ea.color_masks.float()
    C = masks.shape[0]
    plan = sparse_gather.colour_plan(ea.nbr_idx, ea.nbr_w, ea.b, masks)
    plan_one = sparse_gather.colour_plan(first.nbr_idx, first.nbr_w, first.b, masks)
    s = torch.where(torch.rand((B, n), device=dev) < 0.5, 1.0, -1.0)
    u = torch.rand((C, B, n), device=dev)
    beta = torch.full((B,), SAMPLES_RUN["beta"], dtype=torch.float32, device=dev)
    tables = (ea.nbr_idx, ea.nbr_w, ea.b)
    samples4 = torch.where(torch.rand((B, 4, n), device=dev) < 0.5, 1.0, -1.0)
    ms = {"colored_gibbs_sweep_samples": time_ms(torch, lambda: sparse_gather.colored_gibbs_sweep(
              s, *tables, u, masks, beta, plan=plan)),
          "colored_gibbs_sweep_samples_plain": time_ms(torch, lambda: ops.colored_gibbs_sweep(
              s, *tables, u, masks, beta, mode="reference"), n=10, warmup=2),
          "colored_gibbs_sweep_one_table": time_ms(torch, lambda: sparse_gather.colored_gibbs_sweep(
              s, first.nbr_idx, first.nbr_w, first.b, u, masks, beta, plan=plan_one)),
          "uniforms": time_ms(torch, lambda: torch.rand((C, B, n), device=dev)),
          "sparse_energy_samples": time_ms(torch, lambda: sparse_gather.sparse_energy(s, *tables)),
          "sparse_energy_samples_4": time_ms(torch, lambda: sparse_gather.sparse_energy(
              samples4, *tables)),
          "sparse_energy_samples_plain": time_ms(torch, lambda: ops.sparse_energy(
              s, *tables, mode="reference"), n=10, warmup=2)}
    bounds = {"colored_gibbs_sweep_samples": bound(
                  4 * (3 * B * n + n * D + S * n * D + n + C * n + B), B * n * (2 * D + 6),
                  FP32_OPS_PER_S),
              "sparse_energy_samples": bound(4 * (B * n + n * D + S * n * D + n + B),
                                             B * n * (2 * D + 4), FP32_OPS_PER_S)}
    emit({"phase": "timing_samples", "shape": [B, n, S, D, C], "ms": ms,
          "bound_ms": {k: v[0] for k, v in bounds.items()},
          "bound_by": {k: v[1] for k, v in bounds.items()}, "nvidia_smi": smi})
    csrc = "src/repro_torch/kernels/csrc/"
    return [{"name": name, "route": "cuda", "source": csrc + source,
             "replaces": "src/repro/kernels/sparse_gather.py:126" if name.startswith("colored")
             else None, "launches": run_launches[name], "max_abs_err": err[name],
             "mismatches": mism[name], "ms": ms[name], "plain_ms": ms[name + "_plain"],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "shape": [B, n, S, D]}
            for name, source in (("colored_gibbs_sweep_samples", "colored_gibbs.cu"),
                                 ("sparse_energy_samples", "sparse_energy.cu"))]


# The lattice energy (csrc/lattice_energy.cu): run()'s first-hit, start and
# recorded energy under ChromaticGibbs(backend="cuda"). Its terms are
# LatticeIsing.energy's bit for bit and only the order of the sum over the
# sites differs: exact on +-1 states with +-1 couplings (CAL), and otherwise
# within the ENERGY_EPS bound of check_sparse_energy.
LATTICE_ENERGY_SHAPES = ((4096, 16, 16), (40960, 16, 16), (65, 8, 8), (3, 7, 13), (1, 200, 200))
LATTICE_ENERGY_TIMING = ((4096, 16, 16), (40960, 16, 16))  # a sweep's chains, a job's samples
LATTICE_ENERGY_RUN = dict(n_chains=512, n_steps=200, sample_every=50)


def lattice_energy_band(torch, s, w, b):
    """The widest |E_kernel - E_plain| two sum orders allow (ENERGY_EPS)."""
    from repro_torch.kernels import ref

    s64 = s.double()
    pair, field = s64 * ref.king_sum(s64, w.double()), b.double() * s64
    n = s.shape[-2] * s.shape[-1]
    terms = 0.5 * pair.abs().sum((-2, -1)) + field.abs().sum((-2, -1))
    e = (0.5 * pair.sum((-2, -1)) + field.sum((-2, -1))).abs()
    return ENERGY_EPS * (n * terms + e)


def ctmc_event_phase(torch, dev, smi, launches) -> dict:
    """The CTMC's event kernel against its plain version at CTMC_EVENT_CASES,
    bit for bit in s, h, e and t after every event, the draws torch's; its
    CUDA-event median at CTMC_EVENT_SHAPE beside its bound and the plain
    event. Returns the kernels line's entry (`launches`: the ctmc_dense
    phase's)."""
    from repro_torch.core import problems
    from repro_torch.kernels import ctmc_event, ref

    mism, worst = 0, 0.0
    for B, n, events, lambda0 in CTMC_EVENT_CASES:
        prob = problems.sk_instance(n, 1, device=dev)
        g = torch.Generator(device=dev).manual_seed(n)
        s = torch.where(torch.rand((B, n), generator=g, device=dev) < 0.5, 1.0, -1.0)
        state = (s, prob.local_fields(s), prob.energy(s), torch.zeros(B, device=dev))
        beta = 0.3 + 2.7 * torch.rand((B,), generator=g, device=dev)
        differ, err = 0, 0.0
        for _ in range(events):
            expo = torch.empty((B,), device=dev).exponential_(generator=g)
            u = torch.rand((B,), generator=g, device=dev)
            got = ctmc_event.ctmc_event(*state, prob.J, beta, expo, u, lambda0)
            want = ref.ctmc_event_ref(*state, prob.J, beta, expo, u, lambda0)
            differ += sum(int((a != b).sum()) for a, b in zip(got, want))
            err = max([err] + [float((a - b).abs().max()) for a, b in zip(got, want)])
            state = got
        torch.cuda.synchronize()
        emit({"phase": "check_ctmc_event", "shape": [B, n], "events": events,
              "lambda0": lambda0, "mismatches": differ, "max_abs_err": err})
        if differ:
            raise AssertionError(f"ctmc_event at ({B}, {n}): {differ} values of s, h, e, t "
                                 "differ from the plain version")
        mism += differ
        worst = max(worst, err)

    B, n = CTMC_EVENT_SHAPE
    prob = problems.sk_instance(n, 2, device=dev)
    s = torch.where(torch.rand((B, n), device=dev) < 0.5, 1.0, -1.0)
    args = (s, prob.local_fields(s), prob.energy(s), torch.zeros(B, device=dev), prob.J,
            torch.ones(B, device=dev), torch.ones(B, device=dev), torch.rand(B, device=dev))
    ms = time_ms(torch, lambda: ctmc_event.ctmc_event(*args))
    plain_ms = time_ms(torch, lambda: ref.ctmc_event_ref(*args), n=20, warmup=2)
    m = 1 << (n - 1).bit_length()
    bms, by = bound(16 * B * n + 7 * 4 * B, B * (8 * n + (m - 1) + 2 * n), FP32_OPS_PER_S)
    emit({"phase": "timing_ctmc_event", "shape": [B, n], "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "nvidia_smi": smi})
    return {"name": "ctmc_event", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ctmc_event.cu", "replaces": None,
            "launches": launches, "max_abs_err": worst, "mismatches": mism, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": [B, n]}


def lattice_energy_phase(torch, dev, reset, read, smi) -> dict:
    """The lattice energy against the plain version and its emulated order
    at LATTICE_ENERGY_SHAPES, +-1 (CAL at 16x16) and Gaussian; a graphed
    first-hit CAL run() against the plain backend; the kernel's times beside
    its bound and the plain version. Returns the kernels line's entry, less
    its launches, which main() takes from the CAL main path's run."""
    from repro_torch.core import problems
    from repro_torch.core.sampler_api import ChromaticGibbs, geometric, run
    from repro_torch.kernels import lattice_gibbs, ops

    cal = problems.cal_problem(device=dev)

    def pm1(shape):
        return torch.where(torch.rand(shape, device=dev) < 0.5, 1.0, -1.0)

    err, mism = 0.0, 0
    for shape in LATTICE_ENERGY_SHAPES:
        H, W = shape[1:]
        for label in ("pm1", "gaussian"):
            if label == "pm1":
                s = pm1(shape)
                w, b = (cal.w, cal.b) if (H, W) == cal.shape else (
                    pm1((8, H, W)), torch.zeros((H, W), device=dev))
            else:
                s = torch.randn(shape, device=dev)
                w, b = torch.randn((8, H, W), device=dev), 0.3 * torch.randn((H, W), device=dev)
            reset()
            got = lattice_gibbs.lattice_energy(s, w, b)
            launches = read()
            want = ops.lattice_energy(s, w, b, mode="reference")
            order = lattice_gibbs.energy_in_kernel_order(s, w, b)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            off_order = int((got != order).sum())
            case_err = float((got - want).abs().max())
            band = lattice_energy_band(torch, s, w, b)
            outside = int(((got.double() - want.double()).abs() > band).sum())
            if (launches != dict(dict.fromkeys(launches, 0), lattice_energy=1)
                    or (label == "pm1" and differ) or off_order or outside
                    or got.shape != want.shape):
                raise AssertionError(f"lattice_energy {label} {shape}: launched {launches}, "
                                     f"{differ} energies differ from the plain version, "
                                     f"{off_order} from the kernel's order, {outside} outside "
                                     f"the band, max |dE| {case_err}")
            err, mism = max(err, case_err), mism + differ
            emit({"phase": "check_lattice_energy", "weights": label, "shape": list(shape),
                  "route": lattice_gibbs.energy_route(s, H, W),
                  "mismatches": differ, "order_mismatches": off_order, "max_abs_err": case_err,
                  "band_max": float(band.max())})

    # run() with first hit, graphed, against the plain backend on the card
    target = float(cal.energy(torch.as_tensor(problems.cal_template(), device=dev)))
    kw = dict(schedule=geometric(0.3, 3.0), first_hit=target, **LATTICE_ENERGY_RUN)
    reset()
    res_k = run(cal, ChromaticGibbs(), 2147483931, backend="cuda", **kw)
    torch.cuda.synchronize()
    launches = read()
    res_r = run(cal, ChromaticGibbs(), 2147483931, backend="ref", **kw)
    differ = {k: int((getattr(res_k, k) != getattr(res_r, k)).sum())
              for k in ("s", "samples", "energies", "hit", "t_hit")}
    want_energy = energy_launches(kw["n_steps"], kw["sample_every"], target, passes=1)
    if any(differ.values()) or launches["lattice_energy"] != want_energy:
        raise AssertionError(f"lattice_energy run(): {differ} differ between the cuda and the "
                             f"plain backend, launches {launches} (expected {want_energy} "
                             "lattice_energy)")
    emit({"phase": "lattice_energy_run", **LATTICE_ENERGY_RUN, "first_hit": target,
          "mismatches": differ, "energy_launches": launches["lattice_energy"],
          "hit_fraction": float(res_k.hit.float().mean())})

    ms, bounds = {}, {}
    for B, H, W in LATTICE_ENERGY_TIMING:
        s = pm1((B, H, W))
        key = f"lattice_energy_{B}"
        ms[key] = time_ms(torch, lambda: lattice_gibbs.lattice_energy(s, cal.w, cal.b))
        ms[key + "_plain"] = time_ms(torch, lambda: cal.energy(s), n=20, warmup=2)
        bounds[key] = bound(4 * (B * H * W + 9 * H * W + B), 20 * B * H * W, FP32_OPS_PER_S)
    emit({"phase": "timing_lattice_energy", "shapes": [list(x) for x in LATTICE_ENERGY_TIMING],
          "ms": ms, "bound_ms": {k: v[0] for k, v in bounds.items()},
          "bound_by": {k: v[1] for k, v in bounds.items()}, "nvidia_smi": smi})
    key = f"lattice_energy_{LATTICE_ENERGY_TIMING[0][0]}"
    samples = f"lattice_energy_{LATTICE_ENERGY_TIMING[1][0]}"
    return {"name": "lattice_energy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lattice_energy.cu", "replaces": None,
            "max_abs_err": err, "mismatches": mism,
            "ms": ms[key], "plain_ms": ms[key + "_plain"], "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1], "library_ms": None,
            "shape": list(LATTICE_ENERGY_TIMING[0]), "samples_ms": ms[samples],
            "samples_plain_ms": ms[samples + "_plain"], "samples_bound_ms": bounds[samples][0]}


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke.py: {SRC / 'repro_torch'} not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # deterministic cuBLAS for the train phase's resume check: read once, at
    # the process's first matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if sys.argv[1:] == ["--cpu-gates"]:
        return cpu_gates()
    if sys.argv[1:2] == ["--cpu-serve-gates"]:
        return serve_gates("cpu", sys.argv[2:])
    if sys.argv[1:2] == ["--card-serve-gates"]:
        if not torch.cuda.is_available():
            print("chip_smoke.py --card-serve-gates: no CUDA device", file=sys.stderr)
            return 2
        return serve_gates("cuda", sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels need an H100",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--card-train-gates"]:
        return train_gates(torch, np)

    from repro_torch.core import ising, problems
    from repro_torch.core.ising import king_color_masks
    from repro_torch.core.sampler_api import ChromaticGibbs, ColoredGibbs, TauLeap, geometric, run
    from repro_torch.core.sparse import SparseIsing
    from repro_torch.kernels import (_build, dense_field, flash_attention, lattice_gibbs, ops, ref,
                                     sparse_gather, tau_leap)
    from repro_torch.kernels._checks import MAX_SMEM_BYTES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels need (9, 0)")
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in (build_dir / f"{name}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.LIBRARIES
    }
    emit({"phase": "device", "nvidia_smi": smi, "capability": list(cap),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # the instructions the redesigned kernels were compiled to
    sass = sass_counts(build_dir, Path(_build._nvcc()).with_name("cuobjdump"))
    missing = [f"{lib}: {kernel} has no {op}" for lib, kernels in sass.items()
               for kernel, counts in kernels.items()
               for op in SASS_KERNELS.get(kernel.split("<")[0], ()) if counts[op] == 0]
    found = {k.split("<")[0] for kernels in sass.values() for k in kernels}
    missing += [f"no {k} in the libraries" for k in SASS_KERNELS if k not in found]
    emit({"phase": "sass", "counts": sass, "ptxas": {
        lib: ptxas_by_kernel((build_dir / f"{lib}.log").read_text())
        for lib in ("tau_leap", "sparse_fields", "colored_gibbs", "colored_gibbs_long",
                    "sparse_energy", "lattice_gibbs", "lattice_energy", "ctmc_event")}})
    if missing:
        raise AssertionError("SASS: " + "; ".join(missing))

    # -- 2. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(0)
    scale = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=dev)
    dt = torch.tensor(0.3, dtype=torch.float32, device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    err = {"dense_field": 0.0, "tau_leap_step": 0.0}
    mism = {"dense_field": 0, "tau_leap_step": 0}
    near = 0
    for B, N in CHECK_SHAPES:
        s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
        s_i8 = s.to(torch.int8)
        J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
        b = torch.as_tensor(rng.normal(0.0, 0.2, N).astype(np.float32), device=dev)
        u = torch.as_tensor(rng.random((B, N)).astype(np.float32), device=dev)
        beta = torch.as_tensor(rng.uniform(0.3, 3.0, B).astype(np.float32), device=dev)

        acc_k = dense_field.dense_field(s_i8, J, torch.zeros_like(b), one)
        acc_r = ref.dense_acc_ref(s_i8, J)
        n_acc = int((acc_k != acc_r.to(torch.float32)).sum())  # |acc| < 2^24: exact in f32
        h_k = dense_field.dense_field(s_i8, J, b, scale).cpu().numpy()
        h_r = ref.dense_field_ref(s_i8, J, b, scale).cpu().numpy()
        ulps = np.testing.assert_array_max_ulp(h_k, h_r, maxulp=1)
        if n_acc:
            raise AssertionError(f"dense_field ({B},{N}): {n_acc} int32 accumulators differ")
        err["dense_field"] = max(err["dense_field"], float(np.max(np.abs(h_k - h_r))))
        mism["dense_field"] += int(np.count_nonzero(ulps))

        out_k = tau_leap.tau_leap_step(s, J, b, scale, u, dt, beta)
        p = ref.tau_leap_flip_prob_ref(s, J, beta[:, None] * b, (beta * scale)[:, None], dt)
        out_r = torch.where(u < p, -s, s)
        differ = out_k != out_r
        in_band = (u - p).abs() <= P_BAND
        bad = int((differ & ~in_band).sum())
        if bad:
            raise AssertionError(f"tau_leap_step ({B},{N}): {bad} spins differ outside the band")
        err["tau_leap_step"] = max(
            err["tau_leap_step"], float(((out_k - out_r).abs() * ~in_band).max())
        )
        mism["tau_leap_step"] += int(differ.sum())
        near += int(in_band.sum())
        emit({"phase": "check", "B": B, "N": N, "dense_field_max_ulp": int(ulps.max()),
              "dense_field_acc_mismatches": n_acc,
              "tau_leap_mismatches": int(differ.sum()), "tau_leap_in_band": int(in_band.sum())})
    torch.cuda.synchronize()

    def pm1(shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], shape).astype(np.float32), device=dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for name in ("lattice_gibbs_sweep", "lattice_gibbs_sweep_bf16", "lattice_gibbs_generic",
                 "lattice_gibbs_generic_bf16", "sparse_fields",
                 "sparse_fields_global", "colored_gibbs_sweep", "flash_attention",
                 "flash_attention_kv_len"):
        err[name], mism[name] = 0.0, 0
    def lattice_route(route):
        """The sweep through one route, asserting the route taken: the plan
        kernel over the plan of the call's masks, the generic kernel over
        that plan marked not independent (it is exact for any masks)."""
        def sweep(s, w, b, u, colors, frozen, clampv, beta):
            plan = lattice_gibbs.lattice_plan(w, b, colors, frozen, clampv)
            if route == "lattice_gibbs_generic":
                plan = plan._replace(independent=False)
            read = counters()[1]
            out = lattice_gibbs.lattice_gibbs_sweep(s, w, b, u, colors, frozen, clampv, beta,
                                                    plan=plan)
            taken = read()
            if taken != dict(dict.fromkeys(taken, 0), **{route: 1}):
                raise AssertionError(f"{route} at {tuple(s.shape)}: launched {taken}")
            return out
        return sweep

    lattice_routes = {}  # (B, H, W) -> the routes checked there
    for B, H, W in LATTICE_SHAPES:
        s = pm1((B, H, W))
        w = f32(rng.normal(0.0, 0.5, (8, H, W)))  # asymmetric: pure arithmetic
        b = f32(rng.normal(0.0, 0.3, (H, W)))
        u = f32(rng.random((4, B, H, W)))
        king_b = king_color_masks(H, W, device=dev)
        colors_b = king_b
        if (B, H, W) == (8, 8, 8):  # an improper colouring: phases see the state before them
            colors_b = torch.as_tensor(rng.random((4, H, W)) < 0.5, device=dev)
        frozen_b = torch.as_tensor(rng.random((H, W)) < 0.2, device=dev)
        clampv = pm1((H, W))
        beta = f32(rng.uniform(0.3, 3.0, B))
        colors, frozen = colors_b.float(), frozen_b.float()
        # the wrapper's own choice: the plan kernel for the king colouring
        # wherever its lists fit a block's threads
        plan = lattice_gibbs.lattice_plan(w, b, colors, frozen, clampv)
        if colors_b is king_b and not plan.independent:
            raise AssertionError(f"the king colouring at {(H, W)} is not independent")
        routes = ["lattice_gibbs_generic"]
        if plan.independent and plan.threads:
            routes.insert(0, "lattice_gibbs_sweep")
        lattice_routes[(B, H, W)] = routes
        # The field probes: one phase updating every probed free site. The
        # plan kernel takes one king colour a call, the generic kernel one
        # mask of every site.
        probe_masks = {"lattice_gibbs_sweep": [king_b[c:c + 1].float() for c in range(4)],
                       "lattice_gibbs_generic": [torch.ones((1, H, W), device=dev)]}
        x = -2.0 * (beta[:, None, None] * ref.lattice_fields_ref(s, w, b))
        p = 1.0 / (1.0 + torch.exp(-x))  # p_up formed as the kernels form it
        free = ~frozen_b
        for route in routes:
            sweep = lattice_route(route)
            out_k = sweep(s, w, b, u, colors, frozen, clampv, beta)
            out_r = ops.lattice_gibbs_sweep(s, w, b, u, colors, frozen, clampv, beta,
                                            mode="reference")
            band = phase_band(torch, lambda x: ref.lattice_fields_ref(x, w, b), s, u, colors_b,
                              frozen_b, beta, P_BAND)
            differ = out_k != out_r
            bad = int((differ & ~band).sum())
            n_clamp = int((out_k[:, frozen_b] != clampv[frozen_b]).sum())
            # Fields through p_up: uniforms at the plain p_up give -1 unless
            # the kernel's p_up is larger, one ulp below it +1 unless it is
            # smaller.
            n_field = 0
            for m in probe_masks[route]:
                hi = sweep(s, w, b, p[None].contiguous(), m, frozen, clampv, beta)
                lo = sweep(s, w, b, torch.nextafter(p, torch.tensor(-1.0, device=dev))[None]
                           .contiguous(), m, frozen, clampv, beta)
                probed = free & (m[0] > 0.5)
                n_field += int(((hi != -1.0) & probed).sum() + ((lo != 1.0) & probed).sum())
            if bad or n_clamp or n_field:
                raise AssertionError(
                    f"lattice_gibbs_sweep ({B},{H},{W}) through {route}: {bad} spins differ "
                    f"outside the band, {n_clamp} frozen sites off their clamp value, {n_field} "
                    "fields differ")
            mism[route] += int(differ.sum())
            err[route] = max(err[route], float(((out_k - out_r).abs() * ~band).max()))
            emit({"phase": "check_lattice", "dtype": "float32", "B": B, "H": H, "W": W,
                  "route": route,
                  "threads": plan.threads if route == "lattice_gibbs_sweep" else None,
                  "mismatches": int(differ.sum()), "in_band": int(band.sum()),
                  "field_mismatches": n_field,
                  "sigmoid_vs_kernel_formula": int((torch.sigmoid(x) != p).sum())})

        # bf16: the same inputs rounded to bf16, beta still f32
        sb, wb, bb, ub, cb, fb, cvb = (t.to(torch.bfloat16)
                                       for t in (s, w, b, u, colors, frozen, clampv))
        for route in routes:
            sweep = lattice_route(route)
            out_k = sweep(sb, wb, bb, ub, cb, fb, cvb, beta)
            out_r = ops.lattice_gibbs_sweep(sb, wb, bb, ub, cb, fb, cvb, beta, mode="reference")
            band = phase_band(torch, lambda x: ref.lattice_fields_ref(x, wb, bb), sb, ub,
                              colors_b, frozen_b, beta, P_BAND)
            differ = out_k != out_r
            bad = int((differ & ~band).sum())
            n_clamp = int((out_k[:, frozen_b] != cvb[frozen_b]).sum())
            n_field, n_resolved, n_free, n_zero = bf16_field_probe(
                torch, sweep, sb, wb, bb, fb, cvb,
                [m.to(torch.bfloat16) for m in probe_masks[route]])
            if (out_k.dtype != torch.bfloat16 or bad or n_clamp or n_field
                    or n_resolved < n_free - n_zero):
                raise AssertionError(
                    f"bf16 lattice_gibbs_sweep ({B},{H},{W}) through {route}: out {out_k.dtype}, "
                    f"{bad} spins differ outside the band, {n_clamp} frozen sites off their "
                    f"clamp value, {n_field} fields differ, {n_free - n_zero - n_resolved} "
                    "nonzero fields unresolved")
            mism[route + "_bf16"] += int(differ.sum())
            err[route + "_bf16"] = max(err[route + "_bf16"],
                                       float(((out_k - out_r).float().abs() * ~band).max()))
            emit({"phase": "check_lattice", "dtype": "bfloat16", "B": B, "H": H, "W": W,
                  "route": route, "mismatches": int(differ.sum()), "in_band": int(band.sum()),
                  "field_mismatches": n_field, "field_sites_resolved": n_resolved,
                  "free_sites": n_free, "zero_fields": n_zero})
    if any(r != (["lattice_gibbs_generic"] if shape in GENERIC_ONLY else
                 ["lattice_gibbs_sweep", "lattice_gibbs_generic"])
           for shape, r in lattice_routes.items()):
        raise AssertionError(f"check_lattice took the routes {lattice_routes}")

    # The plan ChromaticGibbs.init builds for CAL: equal to the wrapper's own,
    # and the sweep over it equal to the sweep over a plan built per call.
    cal = problems.cal_problem(device=dev)
    s = pm1((LATTICE_MAIN["n_chains"],) + cal.shape)
    u = torch.rand((4,) + tuple(s.shape), device=dev)
    beta = f32(rng.uniform(0.3, 3.0, s.shape[0]))
    colors_i, frozen_i, clamp_i, plan_i = ChromaticGibbs(backend="cuda").init(
        cal, torch.Generator(device=dev), s0=s).aux
    own = lattice_gibbs.lattice_plan(cal.w, cal.b, colors_i, frozen_i, clamp_i)
    same_plan = (own.independent, own.counts, own.threads) == (
        plan_i.independent, plan_i.counts, plan_i.threads) and all(
        torch.equal(x, y) for x, y in zip(plan_i[:5], own[:5]))
    args = (s, cal.w, cal.b, u, colors_i, frozen_i, clamp_i, beta)
    reset, read = counters()
    reset()
    init_differ = int((lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan_i)
                       != lattice_gibbs.lattice_gibbs_sweep(*args)).sum())
    init_launches = read()
    if not same_plan or init_differ or init_launches["lattice_gibbs_sweep"] != 2:
        raise AssertionError(f"CAL: the init's plan equal to the wrapper's {same_plan}, "
                             f"{init_differ} spins differ, launches {init_launches}")
    emit({"phase": "check_lattice_init_plan", "problem": "cal_problem()",
          "n_chains": s.shape[0], "plan_equal": same_plan, "mismatches": init_differ,
          "counts": list(plan_i.counts), "threads": plan_i.threads})

    rows_seen = set()  # fields rows a block the cases take (0: the global kernel)
    for B, n, graph, arg in SPARSE_CASES:
        if graph == "3regular":
            sp = problems.random_3regular_maxcut(n, arg, device=dev)
        else:
            A = rng.normal(0.0, 0.6, (n, n)) * (rng.random((n, n)) < arg)
            J = np.triu(A, 1)
            sp = SparseIsing.from_dense(ising.DenseIsing.from_numpy(
                J + J.T, rng.normal(0.0, 0.3, n), device=dev))
        idx, w, b = sp.nbr_idx, sp.nbr_w, sp.b
        unit = bool(((w == 0) | (w.abs() == 1)).all()) and not bool(b.any())
        s = pm1((B, n))
        masks_b = sp.color_masks
        if n == 5:  # random masks, an improper colouring
            masks_b = torch.as_tensor(rng.random((3, n)) < 0.5, device=dev)
        C = masks_b.shape[0]
        u = f32(rng.random((C, B, n)))
        beta = f32(rng.uniform(0.3, 3.0, B))
        # the fields kernel is chosen by n: rows that fit one block's shared memory are staged
        variant = "sparse_fields" if n <= MAX_SMEM_BYTES // 4 else "sparse_fields_global"
        rows = sparse_gather.fields_rows(B, n, sparse_gather._sm_count(dev))
        rows_seen.add(rows)
        before = read()
        h_k = sparse_gather.sparse_fields(s, idx, w, b)
        taken = {k: n - before[k] for k, n in read().items()}
        if taken != dict({k: 0 for k in before}, **{variant: 1}):
            raise AssertionError(f"sparse_fields ({B},{n}) launched {taken}, expected one {variant}")
        h_r = ref.sparse_fields_ref(s, idx, w, b)
        fbound = FIELD_EPS * (w.abs().sum(-1) + b.abs())
        dh = (h_k - h_r).abs()
        n_h = int((dh != 0).sum()) if unit else int((dh > fbound).sum())
        out_k = sparse_gather.colored_gibbs_sweep(s, idx, w, b, u, masks_b.float(), beta)
        out_r = ops.colored_gibbs_sweep(s, idx, w, b, u, masks_b.float(), beta, mode="reference")
        tol = beta[:, None] / 2 * fbound + P_BAND
        nofreeze = torch.zeros(n, dtype=torch.bool, device=dev)
        band = phase_band(torch, lambda x: ref.sparse_fields_ref(x, idx, w, b), s, u, masks_b,
                          nofreeze, beta, tol)
        differ = out_k != out_r
        bad = int((differ & ~band).sum())
        # the sweep over the plan ColoredGibbs.init keeps, where the masks are the problem's own
        plan_differ = None
        if masks_b is sp.color_masks:
            masks_i, plan_i = ColoredGibbs(backend="cuda").init(
                sp, torch.Generator(device=dev), s0=s).aux
            out_p = sparse_gather.colored_gibbs_sweep(s, idx, w, b, u, masks_i, beta,
                                                      plan=plan_i)
            plan_differ = int((out_p != out_k).sum())
        if n_h or bad or plan_differ:
            raise AssertionError(f"sparse ({B},{n},{graph}): {n_h} fields out of bound, "
                                 f"{bad} spins differ outside the band, {plan_differ} differ "
                                 "between the init's plan and the wrapper's")
        err[variant] = max(err[variant], float(dh.max()))
        mism[variant] += int((dh != 0).sum())
        mism["colored_gibbs_sweep"] += int(differ.sum())
        err["colored_gibbs_sweep"] = max(err["colored_gibbs_sweep"],
                                         float(((out_k - out_r).abs() * ~band).max()))
        emit({"phase": "check_sparse", "B": B, "n": n, "graph": graph, "max_deg": sp.max_deg,
              "colors": C, "unit_weights": unit, "fields_kernel": variant, "fields_rows": rows,
              "init_plan_mismatches": plan_differ, "field_max_abs_err": float(dh.max()),
              "field_mismatches": int((dh != 0).sum()), "sweep_mismatches": int(differ.sum()),
              "sweep_in_band": int(band.sum())})
    if rows_seen != set(range(sparse_gather.FIELDS_MAX_ROWS + 1)):
        raise AssertionError(f"check_sparse took the fields kernel at rows {sorted(rows_seen)}: "
                             f"every count 0..{sparse_gather.FIELDS_MAX_ROWS} must be checked")
    torch.cuda.synchronize()

    # flash_attention against its plain version; inputs from their own
    # generator, so the phases before and after see the numbers they did
    frng = np.random.default_rng(13)

    def normal(shape, dtype):
        return torch.as_tensor(frng.normal(0.0, 0.5, shape).astype(np.float32),
                               device=dev).to(dtype)

    for BH, Sq, Sk, d, causal, dtype in FLASH_CASES:
        dt_ = getattr(torch, dtype)
        q, k, v = normal((BH, Sq, d), dt_), normal((BH, Sk, d), dt_), normal((BH, Sk, d), dt_)
        out_k = flash_attention.flash_attention(q, k, v, causal)
        e, ulps = check_attention(torch, ops, (BH, Sq, Sk, d, causal, dtype), out_k, q, k, v,
                                  causal)
        err["flash_attention"] = max(err["flash_attention"], e)
        emit({"phase": "check_flash", "BH": BH, "Sq": Sq, "Sk": Sk, "d": d, "causal": causal,
              "dtype": dtype, "max_abs_err": e, "tol": FLASH_TOL[dtype],
              "max_bf16_ulps": ulps if dtype == "bfloat16" else None})
        del q, k, v, out_k
    torch.cuda.synchronize()

    # the key-length bound on both kernels, non-causal; a bound of Sk is the
    # unbounded launch bit for bit, and a bound below Sk with the causal mask
    # raises before any launch
    for BH, Sq, Sk, d, kv_len in FLASH_KV_LEN_CASES:
        for dtype in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype)
            q, k, v = normal((BH, Sq, d), dt_), normal((BH, Sk, d), dt_), normal((BH, Sk, d), dt_)
            out_k = flash_attention.flash_attention(q, k, v, False, kv_len=kv_len)
            e, ulps = check_attention(torch, ops, (BH, Sq, Sk, d, "kv_len", kv_len, dtype), out_k,
                                      q, k, v, False, kv_len=kv_len)
            err["flash_attention_kv_len"] = max(err["flash_attention_kv_len"], e)
            full = bool(torch.equal(flash_attention.flash_attention(q, k, v, False, kv_len=Sk),
                                    flash_attention.flash_attention(q, k, v, False)))
            before = read()
            try:
                flash_attention.flash_attention(q, k, v, True, kv_len=kv_len)
                refused = False
            except ValueError:
                refused = read() == before
            if not (full and refused):
                raise AssertionError(f"flash_attention ({BH}, {Sq}, {Sk}, {d}, {dtype}): kv_len "
                                     f"= Sk equal to the unbounded launch {full}, causal with "
                                     f"kv_len {kv_len} refused {refused}")
            emit({"phase": "check_flash", "BH": BH, "Sq": Sq, "Sk": Sk, "d": d, "causal": False,
                  "kv_len": kv_len, "dtype": dtype, "max_abs_err": e, "tol": FLASH_TOL[dtype],
                  "max_bf16_ulps": ulps if dtype == "bfloat16" else None,
                  "kv_len_sk_equals_unbounded": full, "causal_kv_len_refused": refused})
            del q, k, v, out_k
    torch.cuda.synchronize()

    # the band on both kernels; a window as wide as the keys is the causal
    # launch bit for bit
    err["flash_attention_window"], mism["flash_attention_window"] = 0.0, 0
    for BH, S, d, window in FLASH_WINDOW_CASES:
        for dtype in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype)
            q, k, v = (normal((BH, S, d), dt_) for _ in range(3))
            out_k = flash_attention.flash_attention(q, k, v, True, window)
            e, ulps = check_attention(torch, ops, (BH, S, d, window, dtype), out_k, q, k, v, True,
                                      window)
            err["flash_attention_window"] = max(err["flash_attention_window"], e)
            causal = flash_attention.flash_attention(q, k, v, True)
            wide = {w: bool(torch.equal(flash_attention.flash_attention(q, k, v, True, w), causal))
                    for w in (S, S + 77)}
            if not all(wide.values()):
                raise AssertionError(f"flash_attention ({BH}, {S}, {d}, {dtype}): a window as "
                                     f"wide as the keys differs from the causal launch: {wide}")
            emit({"phase": "check_flash_window", "BH": BH, "S": S, "d": d, "window": window,
                  "dtype": dtype, "max_abs_err": e, "tol": FLASH_TOL[dtype],
                  "max_bf16_ulps": ulps if dtype == "bfloat16" else None,
                  "wide_window_equals_causal": wide})
            del q, k, v, out_k, causal
    torch.cuda.synchronize()

    # the fault variants of the three run() kernels against their plain versions
    fault_err, fault_mism = check_faults_kernels(torch, np, dev, read)
    err.update(fault_err)
    mism.update(fault_mism)

    # -- 3. timings at the main path's shape --------------------------------
    B, N = TIME_SHAPE
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
    s_i8 = s.to(torch.int8)
    J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
    b = torch.zeros(N, dtype=torch.float32, device=dev)
    u = torch.rand((B, N), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    ms = {
        "dense_field": time_ms(torch, lambda: dense_field.dense_field(s_i8, J, b, scale)),
        "dense_field_plain": time_ms(torch, lambda: ref.dense_field_ref(s_i8, J, b, scale)),
        "tau_leap_step": time_ms(
            torch, lambda: tau_leap.tau_leap_step(s, J, b, scale, u, dt, beta)),
        "tau_leap_step_plain": time_ms(
            torch, lambda: ops.tau_leap_step(s, J, b, scale, u, dt, beta=beta, mode="reference")),
        "int_mm": time_ms(torch, lambda: torch._int_mm(s_i8, J.t())),
    }
    bounds = {
        "dense_field": bound(N * N + B * N + 4 * N + 4 + 4 * B * N, 2.0 * B * N * N),
        "tau_leap_step": bound(N * N + 3 * 4 * B * N + 4 * N + 4 * B + 8, 2.0 * B * N * N),
    }
    emit({"phase": "timing", "B": B, "N": N, "ms": ms,
          "bound_ms": {k: v[0] for k, v in bounds.items()}, "nvidia_smi": smi})

    # The chromatic-Gibbs kernels at their main paths' shapes. Bounds count
    # what these inputs need: each input read once, the output written once,
    # and of the (C, B, ...) uniforms only those of the sites a phase updates.
    cal = problems.cal_problem(device=dev)
    H, W = cal.shape
    B = LATTICE_MAIN["n_chains"]
    s = pm1((B, H, W))
    colors = king_color_masks(H, W, device=dev).float()
    frozen = cal.frozen_mask.float()
    clampv = cal.frozen_values
    u = torch.rand((4, B, H, W), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    lat_plan = lattice_gibbs.lattice_plan(cal.w, cal.b, colors, frozen, clampv)  # as init builds it
    ms["lattice_gibbs_sweep"] = time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
        s, cal.w, cal.b, u, colors, frozen, clampv, beta, plan=lat_plan))
    ms["lattice_gibbs_sweep_plain"] = time_ms(torch, lambda: ops.lattice_gibbs_sweep(
        s, cal.w, cal.b, u, colors, frozen, clampv, beta, mode="reference"))
    # the other device work of a CAL sweep: its (4, B, H, W) uniforms
    ms["cal_sweep_uniforms"] = time_ms(torch, lambda: torch.rand((4, B, H, W), device=dev))
    updated = float((colors * (1.0 - frozen)).sum())  # sites updated per chain and sweep
    HW = H * W
    bounds["lattice_gibbs_sweep"] = bound(
        4 * (2 * B * HW + B * updated + 8 * HW + HW + 4 * HW + 2 * HW + B),
        B * updated * 22, FP32_OPS_PER_S)  # 8 mul + 9 add, beta, -2, exp, add, div
    # the first port's design, the generic kernel, at the same shape (a plan marked
    # not independent takes it)
    generic_plan = lat_plan._replace(independent=False)
    ms["lattice_gibbs_generic_cal"] = time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
        s, cal.w, cal.b, u, colors, frozen, clampv, beta, plan=generic_plan))
    lat_bf16 = [t.to(torch.bfloat16) for t in (s, cal.w, cal.b, u, colors, frozen, clampv)]
    plan_bf16 = lattice_gibbs.lattice_plan(*lat_bf16[1:3], *lat_bf16[4:])
    ms["lattice_gibbs_sweep_bf16"] = time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
        *lat_bf16, beta, plan=plan_bf16))
    ms["lattice_gibbs_sweep_bf16_plain"] = time_ms(torch, lambda: ops.lattice_gibbs_sweep(
        *lat_bf16, beta, mode="reference"))
    bounds["lattice_gibbs_sweep_bf16"] = bound(
        2 * (2 * B * HW + B * updated + 8 * HW + HW + 4 * HW + 2 * HW) + 4 * B,
        B * updated * 22, FP32_OPS_PER_S)
    generic_plan_bf16 = plan_bf16._replace(independent=False)
    ms["lattice_gibbs_generic_cal_bf16"] = time_ms(
        torch, lambda: lattice_gibbs.lattice_gibbs_sweep(*lat_bf16, beta, plan=generic_plan_bf16))
    lattice_floor_ms = lattice_sector_floor_ms(torch, lat_plan, B, 4)
    lattice_floor_bf16_ms = lattice_sector_floor_ms(torch, plan_bf16, B, 2)
    del lat_bf16
    lat_host_us = lattice_host_us(lattice_gibbs, (s, cal.w, cal.b, u, colors, frozen, clampv, beta),
                                  lat_plan)
    # the generic kernel at the random-mask shape of check_lattice
    Bg, Hg, Wg = GENERIC_SHAPE
    grng = np.random.default_rng(8)
    gen = [pm1((Bg, Hg, Wg)), f32(grng.normal(0.0, 0.5, (8, Hg, Wg))),
           f32(grng.normal(0.0, 0.3, (Hg, Wg))), f32(grng.random((4, Bg, Hg, Wg))),
           f32(grng.random((4, Hg, Wg)) < 0.5), f32(grng.random((Hg, Wg)) < 0.2), pm1((Hg, Wg)),
           f32(grng.uniform(0.3, 3.0, Bg))]
    plan_g = lattice_gibbs.lattice_plan(*gen[1:3], *gen[4:7])
    if plan_g.independent:
        raise AssertionError(f"the random masks at {GENERIC_SHAPE} are independent sets")
    ms["lattice_gibbs_generic"] = time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
        *gen, plan=plan_g))
    ms["lattice_gibbs_generic_plain"] = time_ms(torch, lambda: ops.lattice_gibbs_sweep(
        *gen, mode="reference"))
    updated_g = float((gen[4] * (1.0 - gen[5])).sum())
    bounds["lattice_gibbs_generic"] = bound(
        4 * (2 * Bg * Hg * Wg + Bg * updated_g + 8 * Hg * Wg + Hg * Wg + 4 * Hg * Wg
             + 2 * Hg * Wg + Bg), Bg * updated_g * 22, FP32_OPS_PER_S)
    del gen
    lattice_shape = [B, H, W]

    mc = problems.random_3regular_maxcut(SPARSE_MAIN["n"], 0, device=dev)
    B, n, D = SPARSE_MAIN["n_chains"], mc.n, mc.max_deg
    s = pm1((B, n))
    masks = mc.color_masks.float()
    C = masks.shape[0]
    u = torch.rand((C, B, n), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    csr = sparse_csr(torch, mc)
    s_t = s.t().contiguous()
    ms["sparse_fields"] = time_ms(torch, lambda: sparse_gather.sparse_fields(
        s, mc.nbr_idx, mc.nbr_w, zeros))
    ms["sparse_fields_plain"] = time_ms(torch, lambda: ref.sparse_fields_ref(
        s, mc.nbr_idx, mc.nbr_w, zeros))
    ms["sparse_mm"] = time_ms(torch, lambda: torch.sparse.mm(csr, s_t))
    plan = sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b, masks)  # once, as init builds it
    ms["colored_gibbs_sweep"] = time_ms(torch, lambda: sparse_gather.colored_gibbs_sweep(
        s, mc.nbr_idx, mc.nbr_w, mc.b, u, masks, beta, plan=plan))
    ms["colored_gibbs_sweep_plain"] = time_ms(torch, lambda: ops.colored_gibbs_sweep(
        s, mc.nbr_idx, mc.nbr_w, mc.b, u, masks, beta, mode="reference"))
    updated = float(masks.sum())
    bounds["sparse_fields"] = bound(4 * (2 * B * n + 2 * n * D + n), B * n * (2 * D + 1),
                                    FP32_OPS_PER_S)
    bounds["colored_gibbs_sweep"] = bound(
        4 * (2 * B * n + B * updated + 2 * n * D + n + C * n + B),
        B * updated * (2 * D + 6), FP32_OPS_PER_S)
    # The sweep's sector floor: the uniforms a phase reads lie spread over its
    # (B, n) plane, so in the (C, B, n) layout they cost every 32-byte sector
    # they touch; plus s, the new s, the plan and beta.
    u_sectors = sum(int(torch.unique(plan.sites[a:z] // 8).numel())
                    for a, z in zip(plan.offsets[:-1].tolist(), plan.offsets[1:].tolist()))
    plan_bytes = sum(x.numel() * x.element_size() for x in (plan.offsets, plan.idx, plan.w))
    sector_floor_ms = (4 * 2 * B * n + 32 * B * u_sectors + plan_bytes + 4 * B) / HBM_BYTES_PER_S * 1e3

    # sparse_fields_global, the kernel for rows too long to stage, at as many
    # outputs as the main path's: its own bound, plain version and library call
    Bg, ng = GLOBAL_FIELDS_SHAPE
    mg = problems.random_3regular_maxcut(ng, 2, device=dev)
    sg = pm1((Bg, ng))
    zg = torch.zeros(ng, dtype=torch.float32, device=dev)
    csr_g, sg_t = sparse_csr(torch, mg), sg.t().contiguous()
    before = read()
    sparse_gather.sparse_fields(sg, mg.nbr_idx, mg.nbr_w, zg)
    if read()["sparse_fields_global"] != before["sparse_fields_global"] + 1:
        raise AssertionError(f"sparse_fields at {GLOBAL_FIELDS_SHAPE} did not take the global kernel")
    ms["sparse_fields_global"] = time_ms(torch, lambda: sparse_gather.sparse_fields(
        sg, mg.nbr_idx, mg.nbr_w, zg))
    ms["sparse_fields_global_plain"] = time_ms(torch, lambda: ref.sparse_fields_ref(
        sg, mg.nbr_idx, mg.nbr_w, zg))
    ms["sparse_mm_global"] = time_ms(torch, lambda: torch.sparse.mm(csr_g, sg_t))
    bounds["sparse_fields_global"] = bound(4 * (2 * Bg * ng + 2 * ng * mg.max_deg + ng),
                                           Bg * ng * (2 * mg.max_deg + 1), FP32_OPS_PER_S)
    del mg, sg, zg, csr_g, sg_t
    emit({"phase": "timing_gibbs", "lattice_shape": lattice_shape, "sparse_shape": [B, n],
          "max_deg": D, "colors": C, "ms": {k: ms[k] for k in ms if k not in (
              "dense_field", "dense_field_plain", "tau_leap_step", "tau_leap_step_plain",
              "int_mm")},
          "bound_ms": {k: bounds[k][0] for k in (
              "lattice_gibbs_sweep", "lattice_gibbs_sweep_bf16", "lattice_gibbs_generic",
              "sparse_fields", "sparse_fields_global", "colored_gibbs_sweep")},
          "colored_gibbs_sweep_sector_floor_ms": sector_floor_ms,
          "lattice_gibbs_sweep_sector_floor_ms": lattice_floor_ms,
          "lattice_gibbs_sweep_bf16_sector_floor_ms": lattice_floor_bf16_ms,
          "lattice_threads": lat_plan.threads, "lattice_wrapper_host_us": lat_host_us,
          "generic_shape": list(GENERIC_SHAPE),
          "sparse_fields_global_shape": list(GLOBAL_FIELDS_SHAPE),
          "sparse_fields_rows_per_block": sparse_gather.fields_rows(
              B, n, sparse_gather._sm_count(dev)),
          "nvidia_smi": smi})
    time_fault_variants(torch, np, dev, ms, bounds)
    emit({"phase": "timing_faults", "ms": {k: ms[k] for k in ms if "_faults" in k},
          "bound_ms": {k: bounds[k][0] for k in FAULT_VARIANTS},
          "base_ms": {k: ms[k.removesuffix("_faults")] for k in FAULT_VARIANTS
                      if k.removesuffix("_faults") in ms},
          "nvidia_smi": smi})
    long_entry = long_sweep_phase(torch, np, dev, *counters(), smi)
    energy_entries = sparse_energy_phase(torch, np, dev, *counters(), smi)
    samples_entries = samples_phase(torch, np, dev, *counters(), smi)
    lattice_energy_entry = lattice_energy_phase(torch, dev, *counters(), smi)

    # flash_attention at the main_attention shapes, causal bf16, beside its
    # plain version and scaled_dot_product_attention (timed only). Bound:
    # q, k, v and out once each; 4 d FLOPs for each unmasked (q, k) pair.
    # The kernel runs for milliseconds, so fewer launches are timed.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attention_timing = {}
    for name, hq, _, d in ATTENTION_MAIN:
        S = ATTENTION_S
        q, k, v = (0.5 * torch.randn((hq, S, d), device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        t = {"ms": time_ms(torch, lambda: flash_attention.flash_attention(q, k, v, True),
                           n=20, warmup=3),
             "plain_ms": time_ms(torch, lambda: ops.flash_attention(q, k, v, True,
                                                                     mode="reference"),
                                 n=10, warmup=2),
             "library_ms": time_ms(torch, lambda: sdpa(q[None], k[None], v[None],
                                                       is_causal=True))}
        t["bound_ms"], t["bound_by"] = bound(4 * hq * S * d * 2, 4.0 * d * hq * S * (S + 1) / 2,
                                             BF16_OPS_PER_S)
        attention_timing[name] = t
        del q, k, v
    first = attention_timing[ATTENTION_MAIN[0][0]]
    ms["flash_attention"], ms["flash_attention_plain"] = first["ms"], first["plain_ms"]
    ms["sdpa"], bounds["flash_attention"] = first["library_ms"], (first["bound_ms"],
                                                                  first["bound_by"])
    emit({"phase": "timing_attention", "S": ATTENTION_S, "dtype": "bfloat16", "causal": True,
          "shapes": {name: [hq, ATTENTION_S, d] for name, hq, _, d in ATTENTION_MAIN},
          "by_config": attention_timing, "nvidia_smi": smi})

    # the band at recurrentgemma's shape, bf16, beside its plain version and
    # SDPA with the band as a boolean mask (timed only). Bound: q, k, v and
    # out once each; 4 d FLOPs for each of the band's pairs.
    BH, S, d, window = FLASH_WINDOW_CASES[0]
    q, k, v = (0.5 * torch.randn((BH, S, d), device=dev, dtype=torch.bfloat16) for _ in range(3))
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    ms["flash_attention_window"] = time_ms(
        torch, lambda: flash_attention.flash_attention(q, k, v, True, window), n=20, warmup=3)
    ms["flash_attention_window_plain"] = time_ms(
        torch, lambda: ops.flash_attention(q, k, v, True, mode="reference", window=window),
        n=10, warmup=2)
    ms["sdpa_window"] = time_ms(torch, lambda: sdpa(q[None], k[None], v[None], attn_mask=band))
    pairs = window * (window + 1) / 2 + (S - window) * window
    bounds["flash_attention_window"] = bound(4 * BH * S * d * 2, 4.0 * d * BH * pairs,
                                             BF16_OPS_PER_S)
    emit({"phase": "timing_attention_window", "shape": [BH, S, d], "window": window,
          "dtype": "bfloat16", "pairs_per_head": pairs,
          **{key: ms[name] for key, name in (("ms", "flash_attention_window"),
                                             ("plain_ms", "flash_attention_window_plain"),
                                             ("library_ms", "sdpa_window"))},
          "bound_ms": bounds["flash_attention_window"][0],
          "bound_by": bounds["flash_attention_window"][1], "nvidia_smi": smi})
    del q, k, v, band

    # the key-length bound at whisper-medium's encoder shape, bf16, beside its
    # plain version and SDPA on the unpadded keys (timed only). Bound: q, k,
    # v and out once each (padded); 4 d FLOPs for each of the kv_len x kv_len
    # pairs of the frames.
    BH, Sq, Sk, d, kv_len = FLASH_KV_LEN_CASES[0]
    q, k, v = (0.5 * torch.randn((BH, S_, d), device=dev, dtype=torch.bfloat16)
               for S_ in (Sq, Sk, Sk))
    ms["flash_attention_kv_len"] = time_ms(
        torch, lambda: flash_attention.flash_attention(q, k, v, False, kv_len=kv_len), n=50)
    ms["flash_attention_kv_len_plain"] = time_ms(
        torch, lambda: ops.flash_attention(q, k, v, False, mode="reference", kv_len=kv_len), n=20)
    k_, v_ = k[:, :kv_len], v[:, :kv_len]
    ms["sdpa_kv_len"] = time_ms(torch, lambda: sdpa(q[None, :, :kv_len], k_[None], v_[None],
                                                    is_causal=False))
    bounds["flash_attention_kv_len"] = bound(2 * BH * (Sq + Sk) * d * 2,
                                             4.0 * d * BH * kv_len**2, BF16_OPS_PER_S)
    emit({"phase": "timing_attention_kv_len", "shape": [BH, Sq, Sk, d], "kv_len": kv_len,
          "dtype": "bfloat16", "causal": False,
          **{key: ms[name] for key, name in (("ms", "flash_attention_kv_len"),
                                             ("plain_ms", "flash_attention_kv_len_plain"),
                                             ("library_ms", "sdpa_kv_len"))},
          "bound_ms": bounds["flash_attention_kv_len"][0],
          "bound_by": bounds["flash_attention_kv_len"][1], "nvidia_smi": smi})
    del q, k, v, k_, v_

    # -- 4. the main path ---------------------------------------------------
    n, n_steps, n_chains = 2048, 2000, 256
    prob = problems.sk_instance(n, 0)
    kw = dict(n_steps=n_steps, n_chains=n_chains, schedule=geometric(0.3, 3.0),
              sample_every=100, timeit=True)
    main = {}
    for label, backend, first_hit in (("cuda_first_hit", "cuda", -0.70 * n),
                                      ("cuda", "cuda", None),
                                      ("ref_first_hit", "ref", -0.70 * n)):
        reset()
        res = run(prob, TauLeap(dt=0.1), 0, first_hit=first_hit, backend=backend, **kw)
        counts = {k: read()[k] for k in ("tau_leap_step", "dense_field")}
        e_final = prob.energy(res.s)
        if not bool(torch.isfinite(res.energies).all()) or not bool(torch.isfinite(e_final).all()):
            raise AssertionError(f"{label}: non-finite energies")
        want = 2 * n_steps if backend == "cuda" else 0  # timeit runs two passes
        if counts["tau_leap_step"] != want:
            raise AssertionError(f"{label}: tau_leap_step launched {counts['tau_leap_step']} "
                                 f"times, expected {want} ({n_steps} per pass)")
        main[label] = {
            "backend": backend, "first_hit": first_hit, "launches": counts,
            "chain_steps_per_s": res.timing.chain_steps_per_s,
            "spin_updates_per_s": res.timing.chain_steps_per_s * n,
            "wall_s": res.timing.wall_s, "compile_s": res.timing.compile_s,
            "hit_fraction": None if res.hit is None else float(res.hit.float().mean()),
            "final_energy_per_spin": float(e_final.mean()) / n,
            "final_state": res.s,
        }
    for label, m in main.items():
        if m["final_energy_per_spin"] >= -0.6:
            raise AssertionError(f"{label}: final energy per spin "
                                 f"{m['final_energy_per_spin']} is not below -0.6")
    path_launches = main["cuda_first_hit"]["launches"]

    # The int8 fields of the final states through ops.dense_field: the
    # quantized energy 0.5 s.h + b.s must agree with the float energy.
    s_fin = main["cuda_first_hit"]["final_state"]
    j_i8, j_scale = ops.quantize_dense(prob.J)
    reset()
    h = ops.dense_field(s_fin.to(torch.int8), j_i8, torch.zeros_like(prob.b), j_scale)
    fields_launches = read()["dense_field"]
    if fields_launches != 1:
        raise AssertionError(f"ops.dense_field launched {fields_launches} kernels, expected 1")
    e_q = 0.5 * (s_fin * h).sum(-1) + (prob.b * s_fin).sum(-1)
    rel = float(((e_q - prob.energy(s_fin)).abs() / prob.energy(s_fin).abs()).max())
    if not rel < 1e-2:
        raise AssertionError(f"quantized energy of the final states is off by {rel}")
    for m in main.values():
        del m["final_state"]
    emit({"phase": "main", "problem": "sk_instance(2048, seed=0)", "n_steps": n_steps,
          "n_chains": n_chains, "runs": main, "fields_path": {
              "launches": {"dense_field": fields_launches}, "max_rel_energy_err": rel},
          "nvidia_smi": smi})

    reset, read = counters()
    want = {k: 0 for k in read()}

    def expect(label, launches, **nonzero):
        if launches != dict(want, **nonzero):
            raise AssertionError(f"{label}: launches {launches}, expected {dict(want, **nonzero)}")

    # The lattice main path: the chip's 16x16 core, CAL letters.
    e_t = float(cal.energy(torch.as_tensor(problems.cal_template(), device=dev)))
    lat = gibbs_runs(cal, ChromaticGibbs(), (("cuda_first_hit", "cuda", e_t), ("cuda", "cuda", None),
                                             ("ref_first_hit", "ref", e_t)),
                     reset, read, **LATTICE_MAIN)
    n_sweeps = LATTICE_MAIN["n_sweeps"]
    for label, m in lat.items():  # timeit runs two passes
        energy = {"lattice_energy": energy_launches(n_sweeps, LATTICE_MAIN["sample_every"],
                                                    m["first_hit"])}
        expect(label, m["launches"], **({"lattice_gibbs_sweep": 2 * n_sweeps, **energy}
                                        if m["backend"] == "cuda" else {}))
        del m["final_state"]
    hits = (lat["cuda_first_hit"]["hit_fraction"], lat["ref_first_hit"]["hit_fraction"])
    if min(hits) < CAL_HIT_MIN or abs(hits[0] - hits[1]) > CAL_HIT_GAP:
        raise AssertionError(f"CAL hit fractions {hits}: need >= {CAL_HIT_MIN}, "
                             f"within {CAL_HIT_GAP} of each other")
    reset()
    exact, agree = clamped_conditional(problems.cal_problem(coupling=0.6, device=dev), "cuda",
                                       LATTICE_MAIN["n_chains"], 400)
    clamped_launches = read()
    expect("clamped conditional", clamped_launches, lattice_gibbs_sweep=400,
           lattice_energy=energy_launches(400, 0, None, passes=1))
    if not exact or not agree > 0.9:
        raise AssertionError(f"clamped conditional: clamped half exact {exact}, "
                             f"free-half agreement {agree} (need > 0.9)")
    emit({"phase": "main_lattice", "problem": "cal_problem()", "template_energy": e_t,
          **LATTICE_MAIN, "runs": lat, "clamped_conditional": {
              "launches": clamped_launches, "clamped_half_exact": exact,
              "free_half_agreement": agree}, "nvidia_smi": smi})

    # The sparse main path: MaxCut on a random 3-regular graph.
    kw = {k: v for k, v in SPARSE_MAIN.items() if k != "n"}
    e_cut = sparse_target(mc)
    sp = gibbs_runs(mc, ColoredGibbs(), (("cuda_first_hit", "cuda", e_cut), ("cuda", "cuda", None),
                                         ("ref_first_hit", "ref", e_cut)),
                    reset, read, **kw)
    n_sweeps = SPARSE_MAIN["n_sweeps"]
    for label, m in sp.items():
        energy = {"sparse_energy": energy_launches(n_sweeps, kw["sample_every"], m["first_hit"])}
        expect(label, m["launches"], **({"colored_gibbs_sweep": 2 * n_sweeps, **energy}
                                        if m["backend"] == "cuda" else {}))
        m["cut_fraction"] = float(cut_fraction(mc, m["final_state"]).mean())
    cuts = (sp["cuda_first_hit"]["cut_fraction"], sp["ref_first_hit"]["cut_fraction"])
    if min(cuts) < CUT_MIN or abs(cuts[0] - cuts[1]) > CUT_REL_GAP * cuts[1]:
        raise AssertionError(f"maxcut3r cut fractions {cuts}: need >= {CUT_MIN}, "
                             f"within {CUT_REL_GAP:.0%} of each other")
    # The fields of the final states through ops.sparse_fields: with unit
    # weights 0.5 s.h + b.s is an integer sum, equal to the energy exactly.
    s_fin = sp["cuda_first_hit"]["final_state"]
    reset()
    h = ops.sparse_fields(s_fin, mc.nbr_idx, mc.nbr_w, torch.zeros_like(mc.b))
    sparse_fields_launches = read()
    expect("sparse fields path", sparse_fields_launches, sparse_fields=1)
    e_fields = 0.5 * (s_fin * h).sum(-1) + (mc.b * s_fin).sum(-1)
    n_energy = int((e_fields != mc.energy(s_fin)).sum())
    if n_energy:
        raise AssertionError(f"sparse fields path: {n_energy} energies differ")
    for m in sp.values():
        del m["final_state"]
    emit({"phase": "main_sparse", "problem": f"random_3regular_maxcut({mc.n}, 0)",
          "max_deg": mc.max_deg, "colors": mc.n_colors, "first_hit": e_cut, **kw, "runs": sp,
          "fields_path": {"launches": sparse_fields_launches, "energy_mismatches": n_energy},
          "nvidia_smi": smi})

    # The attention path: ops.flash_attention at the prefill attention of
    # two full-width configs, the KV heads repeated to the query heads.
    attention = {}
    for name, hq, hkv, d in ATTENTION_MAIN:
        S = ATTENTION_S
        q = normal((1, hq, S, d), torch.bfloat16)
        k, v = (normal((1, hkv, S, d), torch.bfloat16).repeat_interleave(hq // hkv, dim=1)
                for _ in range(2))
        q, k, v = (t.reshape(hq, S, d) for t in (q, k, v))
        reset()
        o = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = read()
        expect(f"attention {name}", launches, flash_attention=1, flash_attention_bf16=1)
        e, ulps = check_attention(torch, ops, name, o, q, k, v, True)
        err["flash_attention"] = max(err["flash_attention"], e)
        attention[name] = {"query_heads": hq, "kv_heads": hkv, "head_dim": d, "S": S,
                           "launches": launches, "max_abs_err": e,
                           "tol": FLASH_TOL["bfloat16"], "max_bf16_ulps": ulps}
        del q, k, v, o
    emit({"phase": "main_attention", "batch": 1, "causal": True, "dtype": "bfloat16",
          "configs": attention, "nvidia_smi": smi})

    # -- 5. statistics through the kernel -----------------------------------
    srng = np.random.default_rng(0)
    n5 = 5
    codes = np.triu(srng.integers(-126, 127, (n5, n5)), 1)
    codes = codes + codes.T
    codes[0, 1] = codes[1, 0] = 127  # pin max-abs: quantization is lossless
    small = ising.DenseIsing.from_numpy(codes / 127.0, srng.normal(0, 0.2, n5))
    reset()
    # |J| reaches 1 and chains relax slowly: 4000 steps do not reliably
    # reach the bound (TV 0.016-0.070 over 4 seeds on CPU), 16000 do
    res5 = run(small, TauLeap(dt=0.05), 1, n_steps=16000, n_chains=64, sample_every=4,
               backend="cuda")
    stats_launches = read()["tau_leap_step"]
    _, p_exact = ising.enumerate_boltzmann(small)
    bits = (res5.samples.reshape(-1, n5).cpu().numpy() > 0).astype(np.int64)
    hist = np.bincount(bits @ (1 << np.arange(n5)), minlength=2**n5)
    tv = 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())
    if not tv < 0.06:
        raise AssertionError(f"TV distance {tv} to exact enumeration is not below 0.06")
    emit({"phase": "stats", "n": n5, "n_chains": 64, "n_steps": 16000, "tv": tv,
          "launches": {"tau_leap_step": stats_launches}})

    def tv_to(p_exact, samples, n_sites):
        bits = (samples.reshape(-1, n_sites).cpu().numpy() > 0).astype(np.int64)
        hist = np.bincount(bits @ (1 << np.arange(n_sites)), minlength=2**n_sites)
        return 0.5 * float(np.abs(hist / hist.sum() - p_exact).sum())

    # A 2x3 lattice with random couplings and site (0, 0) clamped to +1: the
    # exact law is the enumeration conditioned on that site.
    pairs = {((y, x), (y + dy, x + dx)): float(srng.normal(0.0, 0.6))
             for y in range(2) for x in range(3) for dy, dx in ising.KING_OFFSETS[4:]
             if y + dy < 2 and 0 <= x + dx < 3}
    clamp = np.zeros((2, 3), bool)
    clamp[0, 0] = True
    lat6 = ising.lattice_from_pairs(2, 3, pairs, biases=srng.normal(0.0, 0.3, (2, 3)),
                                    clamp_mask=clamp, clamp_value=np.ones((2, 3)), device=dev)
    states, p6 = ising.enumerate_boltzmann(lat6.to_dense())
    p6 = np.where(states[:, 0] > 0, p6, 0.0)
    p6 /= p6.sum()
    lat_sweeps, lat_chains = 400, 1024
    reset()
    res6 = run(lat6, ChromaticGibbs(), 2, n_steps=lat_sweeps, n_chains=lat_chains,
               sample_every=2, backend="cuda")
    lat_launches = read()
    expect("lattice stats", lat_launches, lattice_gibbs_sweep=lat_sweeps,
           lattice_energy=energy_launches(lat_sweeps, 2, None, passes=1))
    tv_lat = tv_to(p6, res6.samples[:, 5:], 6)  # the first 5 samples are burn-in
    # An 8-site random weighted graph through the coloured kernel.
    A = srng.normal(0.0, 0.6, (8, 8)) * (srng.random((8, 8)) < 0.5)
    sp8 = SparseIsing.from_dense(ising.DenseIsing.from_numpy(
        np.triu(A, 1) + np.triu(A, 1).T, srng.normal(0.0, 0.3, 8), device=dev))
    _, p8 = ising.enumerate_boltzmann(sp8.to_dense())
    sp_sweeps, sp_chains = 200, 4096
    reset()
    res8 = run(sp8, ColoredGibbs(), 3, n_steps=sp_sweeps, n_chains=sp_chains, sample_every=2,
               backend="cuda")
    sp_launches = read()
    expect("sparse stats", sp_launches, colored_gibbs_sweep=sp_sweeps,
           sparse_energy=energy_launches(sp_sweeps, 2, None, passes=1))
    tv_sp = tv_to(p8, res8.samples[:, 5:], 8)
    if not (tv_lat < TV_GIBBS_MAX and tv_sp < TV_GIBBS_MAX):
        raise AssertionError(f"TV distances {tv_lat} (lattice), {tv_sp} (sparse) are not "
                             f"below {TV_GIBBS_MAX}")
    emit({"phase": "stats_gibbs", "lattice": {"shape": [2, 3], "clamped_sites": 1,
                                              "n_chains": lat_chains, "n_steps": lat_sweeps,
                                              "tv": tv_lat, "launches": lat_launches},
          "sparse": {"n": 8, "max_deg": sp8.max_deg, "colors": sp8.n_colors,
                     "n_chains": sp_chains, "n_steps": sp_sweeps, "tv": tv_sp,
                     "launches": sp_launches}})

    # -- 6. the graph, the sync baseline and the exact CTMC ------------------
    from repro_torch.core import ctmc as ctmc_mod
    from repro_torch.core import event_tree
    from repro_torch.core.graph_loop import GRAPH_STEPS
    from repro_torch.core.sampler_api import CTMC, _make_run, constant

    def incremental_energy_gap(label, problem, state):
        """|e - E(s)| of the final states, held to ENERGY_ATOL + ENERGY_RTOL |E|."""
        e_true = problem.energy(state.s)
        gap = (state.e - e_true).abs()
        over = int((gap > ENERGY_ATOL + ENERGY_RTOL * e_true.abs()).sum())
        if over or not bool(torch.isfinite(state.e).all()):
            raise AssertionError(f"{label}: the incremental energy of {over} final states is "
                                 f"off by more than {ENERGY_ATOL} + {ENERGY_RTOL} |E| "
                                 f"(max gap {float(gap.max())})")
        return float(gap.max())

    def timed_pass(make):
        """One pass of a _Run, timed from the host with the device synced."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = make()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # Graph against eager: each path graphed and through the private eager
    # loop on the same seed, with and without first_hit; of two passes (as
    # run's timeit) the second gives the per-step wall. Every path here is
    # deterministic (no atomics meet at an address): results must be identical.
    sched = geometric(0.3, 3.0)
    graph_paths = (
        ("sk_tau_leap", prob, TauLeap(dt=0.1), "cuda", -0.70 * n, 256, 500, 100, sched),
        ("cal_chromatic", cal, ChromaticGibbs(), "cuda", e_t, LATTICE_MAIN["n_chains"], 500, 50,
         sched),
        ("maxcut3r_colored", mc, ColoredGibbs(), "cuda", e_cut, 256, 500, 100, sched),
        ("sk_ctmc", prob, CTMC(), None, -0.70 * n, 256, 300, 50, sched),
        ("maxcut3r_ctmc", mc, CTMC(), None, e_cut, 256, 300, 50, constant(3.0)),
    )
    graph_eager = {}
    for name, problem, kernel, backend, target, chains, steps, every, schedule in graph_paths:
        for first_hit in (None, target):
            label = name + ("_first_hit" if first_hit is not None else "")
            out = {}
            for mode in ("graph", "eager"):
                reset()
                make = _make_run(problem, kernel, 5, n_steps=steps, n_chains=chains,
                                 sample_every=every, schedule=schedule, first_hit=first_hit,
                                 backend=backend, eager=mode == "eager")
                _, first_s = timed_pass(make)
                res, wall = timed_pass(make)
                out[mode] = (res, read(), wall, first_s)
            (g, g_launch, g_wall, g_first), (e, e_launch, e_wall, _) = out["graph"], out["eager"]
            fields = ("s", "t", "samples", "times", "energies", "t_hit", "hit")
            differ = [f for f in fields if getattr(g, f) is not None
                      and not torch.equal(getattr(g, f), getattr(e, f))]
            if differ:
                raise AssertionError(f"graph against eager, {label}: {differ} differ")
            if g_launch != e_launch:
                raise AssertionError(f"graph against eager, {label}: launches {g_launch} "
                                     f"graphed, {e_launch} eager")
            kname = {"sk_tau_leap": "tau_leap_step", "cal_chromatic": "lattice_gibbs_sweep",
                     "maxcut3r_colored": "colored_gibbs_sweep"}.get(name)
            energy = {"maxcut3r_colored": {"sparse_energy": energy_launches(steps, every, first_hit)},
                      "cal_chromatic": {"lattice_energy": energy_launches(steps, every, first_hit)}
                      }.get(name, {})
            expect(f"graph {label}", g_launch, **({kname: 2 * steps} if kname else {}), **energy)
            graph_eager[label] = {
                "n_chains": chains, "n_steps": steps, "identical": list(fields),
                "graph_us_per_step": g_wall / steps * 1e6,
                "eager_us_per_step": e_wall / steps * 1e6,
                "graph_first_pass_extra_s": g_first - g_wall,
                "launches": {k: v for k, v in g_launch.items() if v}}
    emit({"phase": "graph_vs_eager", "graph_steps": GRAPH_STEPS, "paths": graph_eager,
          "nvidia_smi": smi})

    # The exact CTMC, dense: the tree draw on SK, unroll "auto" (= 2).
    if CTMC().preferred_unroll(prob) != 2 or CTMC().resolved_site_draw(prob) != "tree":
        raise AssertionError("CTMC on SK n=2048 does not resolve to the tree draw at unroll 2")
    c = CTMC_MAIN
    dense_kw = dict(n_steps=c["n_events"], n_chains=c["n_chains"], schedule=sched,
                    first_hit=-0.70 * n, sample_every=CTMC_SAMPLE_EVERY)
    reset()
    make = _make_run(prob, CTMC(), 0, **dense_kw)
    res, wall = timed_pass(make)
    expect("ctmc_dense", read())
    gap = incremental_energy_gap("ctmc_dense", prob, make.final_state)
    # the same run on the event kernel: a launch an event, the plain backend's results
    reset()
    make_k = _make_run(prob, CTMC(), 0, backend="cuda", **dense_kw)
    res_k, wall_k = timed_pass(make_k)
    ctmc_launches = read()
    expect("ctmc_dense cuda", ctmc_launches, ctmc_event=c["n_events"])
    ctmc_fields = ("s", "t", "samples", "times", "energies", "hit", "t_hit")
    differ = [f for f in ctmc_fields if not torch.equal(getattr(res_k, f), getattr(res, f))]
    if differ:
        raise AssertionError(f"ctmc_dense: the event kernel's run differs from the plain "
                             f"backend's in {differ}")
    emit({"phase": "ctmc_dense", "problem": f"sk_instance({n}, 0)", **c, "unroll": 2,
          "graph_steps": GRAPH_STEPS, "first_hit": -0.70 * n, "wall_s": wall,
          "chain_events_per_s": c["n_events"] * c["n_chains"] / wall,
          "hit_fraction": float(res.hit.float().mean()),
          "final_energy_per_spin": float(prob.energy(res.s).mean()) / n,
          "max_energy_gap": gap, "cuda": {
              "identical": list(ctmc_fields), "wall_s": wall_k,
              "chain_events_per_s": c["n_events"] * c["n_chains"] / wall_k,
              "launches_per_step": ctmc_launches["ctmc_event"] / c["n_events"]},
          "nvidia_smi": smi})
    ctmc_event_entry = ctmc_event_phase(torch, dev, smi, ctmc_launches["ctmc_event"])

    # The exact CTMC, sparse: maxcut3r at a constant beta, the incremental
    # tree path; the carried tree against the rates of the final s and h.
    reset()
    make = _make_run(mc, CTMC(), 0, n_steps=c["n_events"], n_chains=c["n_chains"],
                     schedule=c["sparse_beta"], first_hit=e_cut)
    res, wall = timed_pass(make)
    expect("ctmc_sparse", read())
    st = make.final_state
    if st.aux.tree_beta is None:
        raise AssertionError("ctmc_sparse: the constant-beta run did not carry its tree")
    gap = incremental_energy_gap("ctmc_sparse", mc, st)
    beta3 = torch.full((c["n_chains"],), c["sparse_beta"], dtype=torch.float32, device=dev)
    rates = CTMC().rates(mc, st.s, st.aux.h, beta3)
    leaf_rel = float(((event_tree.leaves(st.aux.tree, mc.n) - rates).abs() / rates).max())
    fresh = event_tree.total(event_tree.build(rates))
    root_rel = float(((event_tree.total(st.aux.tree) - fresh).abs() / fresh).max())
    h_gap = float((st.aux.h - mc.local_fields(st.s)).abs().max())
    if not (leaf_rel <= TREE_LEAF_RTOL and root_rel <= TREE_ROOT_RTOL):
        raise AssertionError(f"ctmc_sparse: the carried tree's leaves are off the rates by "
                             f"{leaf_rel} (relative, bound {TREE_LEAF_RTOL}), its root off a "
                             f"fresh build by {root_rel} (bound {TREE_ROOT_RTOL})")
    emit({"phase": "ctmc_sparse", "problem": f"random_3regular_maxcut({mc.n}, 0)", **c,
          "unroll": CTMC().preferred_unroll(mc), "wall_s": wall,
          "chain_events_per_s": c["n_events"] * c["n_chains"] / wall,
          "cut_fraction": float(cut_fraction(mc, res.s).mean()),
          "hit_fraction": float(res.hit.float().mean()), "max_energy_gap": gap,
          "tree_leaf_max_rel_err": leaf_rel, "tree_root_max_rel_err": root_rel,
          "fields_max_abs_err": h_gap, "nvidia_smi": smi})

    # The synchronous baseline: random-scan Gibbs on SK.
    reset()
    make = _make_run(prob, "random_scan_gibbs", 0, n_steps=c["n_events"],
                     n_chains=c["n_chains"], schedule=sched)
    res, wall = timed_pass(make)
    expect("random_scan", read())
    gap = incremental_energy_gap("random_scan", prob, make.final_state)
    emit({"phase": "random_scan", "problem": f"sk_instance({n}, 0)", **c, "wall_s": wall,
          "chain_steps_per_s": c["n_events"] * c["n_chains"] / wall,
          "final_energy_per_spin": float(prob.energy(res.s).mean()) / n,
          "max_energy_gap": gap, "nvidia_smi": smi})

    # Fidelity through the graph: the 5-spin problem of the JAX tests,
    # chains as rows, against exact enumeration.
    frng = np.random.default_rng(0)
    A5 = frng.normal(0, 0.7, (5, 5))
    p5 = ising.DenseIsing.from_numpy(np.triu(A5, 1) + np.triu(A5, 1).T, frng.normal(0, 0.4, 5),
                                     device=dev)
    _, p5_exact = ising.enumerate_boltzmann(p5)
    f = FIDELITY
    rs = run(p5, "random_scan_gibbs", 1, n_steps=f["n_steps"], n_chains=f["n_chains"],
             sample_every=1)
    tv_rs = tv_to(p5_exact, rs.samples[:, f["burn_in"]:], 5)
    ct = run(p5, CTMC(), 2, n_steps=f["n_steps"], n_chains=f["n_chains"], sample_every=1)
    w = ctmc_mod.time_weighted_distribution(ctmc_mod.CTMCRun.from_result(ct), 5)
    tv_ct = 0.5 * float(np.abs(w.double().mean(0).cpu().numpy() - p5_exact).sum())
    if not (tv_rs < TV_GIBBS_MAX and tv_ct < TV_GIBBS_MAX):
        raise AssertionError(f"fidelity: TV {tv_rs} (random scan), {tv_ct} (CTMC, time-"
                             f"weighted) not below {TV_GIBBS_MAX}")
    emit({"phase": "fidelity", "n": 5, **f, "tv_random_scan": tv_rs,
          "tv_ctmc_time_weighted": tv_ct, "bound": TV_GIBBS_MAX})

    # diagnostics=True on the CAL path: nothing sampled changes.
    kw = dict(n_steps=200, n_chains=LATTICE_MAIN["n_chains"], sample_every=50, schedule=sched,
              first_hit=e_t, backend="cuda")
    reset()
    plain = run(cal, ChromaticGibbs(), 4, **kw)
    plain_launches = read()
    reset()
    with_diag = run(cal, ChromaticGibbs(), 4, diagnostics=True, **kw)
    diag_launches = read()
    expect("diagnostics", diag_launches, lattice_gibbs_sweep=200,
           lattice_energy=energy_launches(200, 50, e_t, passes=1))
    differ = [f for f in ("s", "t", "samples", "times", "energies", "t_hit", "hit")
              if not torch.equal(getattr(plain, f), getattr(with_diag, f))]
    d = with_diag.diagnostics
    if differ or plain_launches != diag_launches or not int(d.flips.sum()) > 0:
        raise AssertionError(f"diagnostics on CAL: {differ} differ, launches {plain_launches} / "
                             f"{diag_launches}, flips {int(d.flips.sum())}")
    emit({"phase": "diagnostics", "problem": "cal_problem()", "n_chains": kw["n_chains"],
          "n_steps": 200, "flips": int(d.flips.sum()),
          "flip_rate_mean": float(d.flip_rate.mean()),
          "first_hit_step_median": float(d.first_hit_step.float().median()),
          "energy_mean": float(d.energy_mean.mean()), "launches": diag_launches})

    # -- 7. the device-fault model and the applications ----------------------
    targets = {"sk_tau_leap": -0.70 * n, "cal_chromatic": e_t, "maxcut3r_colored": e_cut,
               "sk_ctmc": -0.70 * n, "maxcut3r_ctmc": e_cut, "sk_random_scan": -0.70 * n}
    fault_launches = fault_paths(torch, dev, prob, cal, mc, targets, reset, read, smi)
    apps_phase(torch, dev, prob, reset, read, smi)
    served = serve_phase(torch, np, dev, reset, read, smi, err)
    baseline = train_phase(torch, np, dev, reset, read, smi)
    shard_phase(torch, dev, reset, read, smi, baseline)
    examples_phase(torch, reset, read, smi)

    # -- summary -------------------------------------------------------------
    def entry(name, source, replaces, launches, library):
        """The kernels line's entry of one kernel or variant."""
        bms, by = bounds[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err[name], "mismatches": mism[name],
                "ms": ms[name], "plain_ms": ms[name + "_plain"], "bound_ms": bms, "bound_by": by,
                "library_ms": None if library is None else ms[library]}

    csrc = "src/repro_torch/kernels/csrc/"
    emit({"kernels": [
        entry("tau_leap_step", csrc + "tau_leap.cu", "src/repro/kernels/tau_leap.py:82",
              path_launches["tau_leap_step"], "int_mm"),
        entry("dense_field", csrc + "dense_field.cu", "src/repro/kernels/dense_field.py:72",
              fields_launches, "int_mm"),
        dict(entry("lattice_gibbs_sweep", csrc + "lattice_gibbs.cu",
                   "src/repro/kernels/lattice_gibbs.py:102",
                   lat["cuda_first_hit"]["launches"]["lattice_gibbs_sweep"], None),
             bf16_ms=ms["lattice_gibbs_sweep_bf16"],
             bf16_plain_ms=ms["lattice_gibbs_sweep_bf16_plain"],
             bf16_bound_ms=bounds["lattice_gibbs_sweep_bf16"][0],
             bf16_max_abs_err=err["lattice_gibbs_sweep_bf16"],
             bf16_mismatches=mism["lattice_gibbs_sweep_bf16"],
             sector_floor_ms=lattice_floor_ms, bf16_sector_floor_ms=lattice_floor_bf16_ms,
             **{f"generic_{key}": value for key, value in entry(
                 "lattice_gibbs_generic", csrc + "lattice_gibbs.cu",
                 "src/repro/kernels/lattice_gibbs.py:102",
                 lat["cuda_first_hit"]["launches"]["lattice_gibbs_generic"], None).items()
                if key not in ("route", "source", "replaces")},
             generic_shape=list(GENERIC_SHAPE),
             generic_bf16_max_abs_err=err["lattice_gibbs_generic_bf16"],
             generic_bf16_mismatches=mism["lattice_gibbs_generic_bf16"],
             generic_at_main_shape_ms=ms["lattice_gibbs_generic_cal"],
             generic_at_main_shape_bf16_ms=ms["lattice_gibbs_generic_cal_bf16"]),
        dict(entry("sparse_fields", csrc + "sparse_fields.cu",
                   "src/repro/kernels/sparse_gather.py:90",
                   sparse_fields_launches["sparse_fields"], "sparse_mm"),
             **{f"global_{key}": value for key, value in entry(
                 "sparse_fields_global", csrc + "sparse_fields.cu",
                 "src/repro/kernels/sparse_gather.py:90",
                 sparse_fields_launches["sparse_fields_global"], "sparse_mm_global").items()
                if key not in ("name", "route", "source", "replaces")},
             global_shape=list(GLOBAL_FIELDS_SHAPE)),
        dict(entry("colored_gibbs_sweep", csrc + "colored_gibbs.cu",
                   "src/repro/kernels/sparse_gather.py:126",
                   sp["cuda_first_hit"]["launches"]["colored_gibbs_sweep"], None),
             sector_floor_ms=sector_floor_ms),
        long_entry,
        *energy_entries,
        *samples_entries,
        # launches on the CAL main path's first-hit run (two passes)
        dict(lattice_energy_entry,
             launches=lat["cuda_first_hit"]["launches"]["lattice_energy"]),
        # launches on the ctmc_dense phase's run on the event kernel
        ctmc_event_entry,
        dict(entry("flash_attention", csrc + "flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:85",
                   sum(a["launches"]["flash_attention"] for a in attention.values())
                   + served["launches"], "sdpa"),
             **{f"{name}_{key}": attention_timing[name][key]
                for name, *_ in ATTENTION_MAIN[1:]
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             **{f"serve_{key}": served[key] for key in ("launches", "shape", "ms", "plain_ms",
                                                        "bound_ms", "library_ms")}),
        # the band: launches on the long request's prefill (recurrentgemma-9b's
        # attn_local layers); times at (16, 4096, 256), window 2048
        dict(entry("flash_attention_window", csrc + "flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:85", served["launches_window"],
                   "sdpa_window"),
             shape=list(FLASH_WINDOW_CASES[0][:3]), window=FLASH_WINDOW_CASES[0][3]),
        # the key-length bound: launches on whisper-medium's served prefills
        # (its encoder and cross-attention layers); times at (16, 1536, 64),
        # kv_len 1500
        dict(entry("flash_attention_kv_len", csrc + "flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:85", served["launches_kv_len"],
                   "sdpa_kv_len"),
             shape=list(FLASH_KV_LEN_CASES[0][:4]), kv_len=FLASH_KV_LEN_CASES[0][4]),
        # the fault variants: launches on the faults phase's graphed runs
        entry("tau_leap_step_faults", csrc + "tau_leap.cu", "src/repro/kernels/tau_leap.py:82",
              fault_launches["sk_tau_leap"]["tau_leap_step_faults"], "int_mm"),
        entry("lattice_gibbs_sweep_faults", csrc + "lattice_gibbs.cu",
              "src/repro/kernels/lattice_gibbs.py:102",
              fault_launches["cal_chromatic"]["lattice_gibbs_sweep_faults"], None),
        entry("lattice_gibbs_generic_faults", csrc + "lattice_gibbs.cu",
              "src/repro/kernels/lattice_gibbs.py:102",
              fault_launches["cal_chromatic"]["lattice_gibbs_generic_faults"], None),
        entry("colored_gibbs_sweep_faults", csrc + "colored_gibbs.cu",
              "src/repro/kernels/sparse_gather.py:126",
              fault_launches["maxcut3r_colored"]["colored_gibbs_sweep_faults"], None),
    ], "tau_leap_in_band": near, "elapsed_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
