"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile]

Phases, in order; each prints one line of findings (the kernel and oracle
phases one per case group) and any failure raises (the exit code is then
non-zero and no result line is printed):

0. device       — require CUDA; print the card's name and power limit; apply
                  the deterministic numerics policy (runtime/torch_runtime.py).
1. build        — build csrc/gbm_paths.cu, csrc/dynamics_paths.cu,
                  csrc/basket_paths.cu, csrc/qmc_paths.cu,
                  csrc/american_paths.cu, csrc/american_dynamics.cu,
                  csrc/lsmc_backward.cu and csrc/lsmc_two_state.cu with nvcc
                  into build/kernels/, one nvcc each, all started together;
                  print each kernel's registers and spills and the path
                  kernels' register-limited occupancy; count the SASS
                  instructions of each branch's log-Euler loop, of the
                  American monitor loops and of the LSMC backward's 16-path
                  block (cuobjdump) for the instruction cap of phases 2, 12,
                  17, 18, 22 and 23, and split the flat GBM TERMINAL and
                  arithmetic-Asian, the curved-term, the Heston, the Merton
                  and the 3-asset basket TERMINAL loops' SASS per path-step,
                  the cliquet kernel's per path (index, coefficients,
                  Philox, transform, exp and clip, store), and the GBM,
                  Heston, Merton and 3-asset basket monitor kernels' loops
                  at every = 1, into Philox, Box–Muller, update and branch
                  (Merton also its count and jump, the monitor kernels their
                  stores), the fused
                  QMC walk's per point into words, normal, bridge and walk,
                  and the QMC bridge kernel's per point and factor into
                  words, normal, bridge and stores (nvdisasm line info; the
                  ``sass-split`` lines, with the update's and the bridge's
                  FFMAs).
2. kernel       — every kernel branch against its plain twin on the same
                  Philox words at C=4 x 2048 x 512 x 16: TERMINAL (and its
                  digital and forward-start routes), barrier up/down, the four
                  lookbacks, variance swap, arithmetic and geometric Asian
                  under both schemes, and the cliquet under log-Euler at 2,
                  3, 4 and 5 periods; then the same payoffs on the
                  curved-term (at 16 and 15 steps), Heston (forward start
                  a branch of its own) and Merton kernels; with antithetic on
                  and off, and an odd step or period count for the pair-step
                  branches. Every branch of the curved-term kernel and the
                  cliquet equals its twin bit for bit on every path (0 paths
                  unequal, printed). Continuous outputs agree to rtol 2e-5 (the
                  lookback encodings against the strike, the cliquet against
                  its cap, where they cross zero); the barrier knock and the
                  digital sign may flip on at most 1e-5 of the paths, and at
                  most 5e-6 of a Heston case's paths may miss, by no more
                  than rtol 1e-3 (the root of a low variance amplifies an
                  ulp; counted, with how low their variance went, and printed;
                  the Heston groups also print the paths that are not the
                  twin's bit for bit);
                  the Merton kernel's jump counts equal its twin's exactly,
                  and its final log-price (written beside the value) its
                  twin's bit for bit in every case, TERMINAL also at 15 and
                  13 steps (the walk's tails).
                  Each branch group is timed at the training chunk 256 x 2048
                  x 512 x 16 (log-Euler) with CUDA events, and its twin's
                  call at the same shape, beside its bound_ms and its
                  share of the SASS instruction cap; the term, Merton and
                  cliquet groups also at the 64 contracts their main path
                  launches.
3. oracle       — the "cuda" engine over 1,048,576 paths per contract, three
                  contracts, normalization "none": each payoff's discounted
                  MC price within 4 standard errors of the port's oracle
                  (Black–Scholes, geometric Asian, discrete barrier,
                  lookback, variance cap and floor, digital, forward start,
                  cliquet; a lattice oracle's own error, estimated by
                  halving its lattice, joins the standard error in
                  quadrature); the arithmetic Asian's sample mean within 4 SE
                  of ``expected_underlier_mean``. Then curved GBM against
                  ``term_effective_black``, Heston against
                  ``heston_call_price`` at 32 steps (the Euler scheme's bias
                  at 16 steps is printed beside it, ungated) and Merton
                  against ``merton_call_price``, each also on the martingale
                  mean E[S_T] = S·e^{(r−q)T}.
4. train        — TERMINAL: GbmCVNNPricer on the "cuda" engine at the
                  production model (256-wide head), 2048 x 512 paths x 16
                  steps per contract, 3 steps of 512 contracts in chunks of
                  256: 6 launches of the TERMINAL branch.
5. resume       — snapshot -> create -> 2 more steps on both: losses bit-equal.
6. serve        — predict_price on 1, 7 and 64 held-out Sobol contracts.
7. train-asian  — phases 4-6 for the arithmetic Asian with MEAN normalization
                  to its own mean: 6 launches of the Asian branch in 3 steps,
                  bit-equal resume, and serving with pad_to_bucket bit-equal
                  and call − put = df·(E[u] − K).
8. payoffs      — every other payoff kind through the trainer at batch 64 (one
                  chunk, one step): the engine and stream version recorded,
                  its kernel branch launched, a finite loss, finite puts, and
                  calls NaN exactly where E[u] has no closed form (barrier,
                  lookback), parity where it has.
9. heston       — phases 4-6 for a Heston pricer (10 inputs into the same
                  256-wide head, TERMINAL, MEAN normalization): 6 launches of
                  the Heston TERMINAL branch in 3 steps, bit-equal resume,
                  serving with pad_to_bucket bit-equal and call-via-parity.
10. families    — phase 8 for every other branch of the Heston kernel, every
                  branch of the Merton kernel and every branch of the term
                  kernel (a GBM pricer under vol and rate curves): one payoff
                  per branch plus the digital and forward-start routes, one
                  step at batch 64 each; calls NaN where the dynamics has no
                  closed-form E[u], parity at the curves' mean rate where it has.
12. basket-kernel — the basket kernel (3 assets; 1 and 8 too) against its
                  twin on the same Philox words at 8 contracts x 2048 x 512 x
                  16: every payoff of every branch group under both combines
                  (the digital and the geometric forward start through
                  TERMINAL), rtol 2e-5, knocks and signs flipped on at most
                  1e-5 of the paths; each branch group timed at 32 contracts
                  (CUDA events; the twin's call) beside its bound and
                  its SASS cap share, and TERMINAL again at the main path's
                  256 contracts (checked there too; its kernel record).
13. qmc-kernel  — the QMC bridge kernel against its twin for F = 1, 2, 3, a
                  padded case (T·F > 64) and T = 8 and 64 at 4 x 2048 x 512
                  points: the Sobol words equal, the normals within 2 ulps,
                  the bridged normals within atol 1e-5, and its sparse
                  instantiation bit-equal to the twin and to its dense one;
                  the fused walk (its sparse instantiation at T = 8, 16, 32,
                  64, off the quad and block grid; the dense one at T = 7)
                  bit-equal to the bridge kernel walked by the torch scan and
                  to its twin; both timed beside bounds, the bridge also at
                  the 64 contracts of phase 16 at F = 1, 2, 3 beside its
                  dense instantiation, the walk at the training chunk, each
                  beside its SASS a point and the instruction cap.
14. oracle-qmc  — the geometric basket against geometric_basket_price, a
                  1-asset arithmetic basket against Black–Scholes, SOBOL_BB
                  GBM TERMINAL and geometric Asian and SOBOL_BB Heston
                  against their oracles (4 SE); the RMSE ratio of pseudo to
                  QMC at an equal budget (bench.py:879-904).
15. train-basket, train-qmc-asian — phases 4-6 for the 3-asset arithmetic
                  basket (bench.py:684-688; TERMINAL, MEAN normalization,
                  stream basket_gbm v2) and for the SOBOL_BB geometric-Asian
                  GBM pricer (MEAN normalization, recorded engine "xla", the
                  fused walk launched once per chunk), each at the
                  production batch and head.
16. families-basket-qmc — one step at batch 64 per basket branch (geometric
                  TERMINAL and variance swap; arithmetic barrier, Asian,
                  lookback, forward start) and per SOBOL_BB family (GBM
                  arithmetic Asian, Heston, the 3-asset basket, Merton: the
                  bridge kernel at F = 1, 2, 3, 1).
17. kernel-american — the American monitor-row kernel against its twin on
                  the same Philox words at 4 x 2048 x 512: T = 16 at every =
                  1, 2, 4, 8, T = 12 at every = 3 and (antithetic) 6,
                  antithetic at every = 1; rtol 2e-5 on the price rows; with
                  every even its last row equal to the TERMINAL kernel's value
                  bit for bit (the shared pair step). Then timed at the training
                  chunk 256 x 2048 x 512 x 16 (every = 1, and every = 4) with
                  the twin, the bound, the SASS per path-step and its cap.
18. kernel-lsmc — the single-state LSMC backward against its twin on the
                  monitor kernel's rows, put and call, at the fused TPU
                  kernel's shape (4 x 2048 x 512 x 16: the resident route)
                  and the streamed one's (4 x 16384 x 256 x 16: past the
                  resident grid, the streamed route): u bit-equal (0 flips),
                  and so is the other route where the contract fits on chip;
                  against the torch estimator the mean within 2e-3 and at
                  most 2% flipped. Then timed at 256 x 2048 x 512 x 16 and at
                  the streamed shape, with the twin, the times of the
                  sweep/solve pair it replaced (44.604 and 3.292 ms), both
                  bounds and the 16-path block's SASS per path against the
                  instruction cap; at 256 x 2048 x 512 x 16 the resident
                  kernel, launched twice, is again bit-equal to the twin.
19. oracle-american — lsmc_price on the card (the two kernels, 1,048,576
                  paths, 16 dates): a put and a dividend call against the
                  Bermudan tree, the r = 0 put and the q = 0 call against
                  Black, each within max(4 SE, 0.5% of the price).
20. train-american, resume-american, serve-american — phases 4-6 for the
                  American put pricer (normalization "none", the CUDA
                  backward, lsmc_backward_version 3 recorded) at the
                  production batch and head, with the step's peak memory;
                  calls NaN.
21. families-american — one step at batch 64 each: the American call (the
                  call column served, the put NaN), cross-fit (the monitor
                  kernel and the torch estimator, backward 0), every = 4,
                  antithetic, basis degree 3, a curved term (the threefry
                  engine, recorded "xla", and a put against
                  bermudan_grid_price within max(4 SE, 1%)), and a
                  4,194,304-path contract at batch 4 (the streamed shape).
22. kernel-american-dynamics — the Heston, Merton and basket monitor-row
                  kernels (csrc/american_dynamics.cu) against their twins on
                  the same Philox words at 4 x 2048 x 512: T = 16 at every =
                  1 (antithetic off and on) and 4, T = 15 at every = 5 and
                  1; the basket with 3 assets arithmetic and geometric and
                  with 1.
                  Price rows rtol 2e-5; Heston's variance rows atol 1e-6 +
                  rtol 2e-5, at most 5e-6 of a case's paths missing either,
                  none past rtol 1e-3 (the variance against θ); the log
                  dispersion within 2e-5 of |ln B|; Merton counts equal; the
                  last row equal to the European kernel's TERMINAL value bit
                  for bit (and Heston's price and variance rows' bit-equality
                  against the twin printed). Then each timed at 256 x 2048 x 512
                  x 16 (the basket at 32 contracts, and without the twin at
                  64 and 256; Merton without it at 64 too) with the twin,
                  the bound and the SASS per path-step against the
                  instruction cap.
23. backward-american-dynamics — the single-state backward against its
                  twin on the Merton and the geometric basket rows and the
                  two-state backward on Heston's and the arithmetic basket's
                  two row sets (u bit-equal, 0 flips, on both routes), put
                  and call; the two-state one against the torch estimator on
                  the card (at most 2% flipped, mean 2e-3), and the torch
                  estimator on the card against its CPU run at 2 x 64 x 512
                  (the same gates); then the two-state backward timed at the
                  training chunk of Heston rows with its peak memory beside
                  the torch estimator it replaced, and at the streamed
                  shape, at each shape launched twice and bit-equal to the
                  twin.
24. oracle-american-dynamics — 1,048,576 paths and 16 dates a contract: the
                  Heston q = 0 call against heston_call_price (4 SE + 2%) and
                  the same-path European (max(3 SE, 0.5%)), a Heston put
                  premium at r = 7%; the Merton r = 0 put and q = 0 call
                  against merton_call_price (4 SE) and the same-path
                  European, a Merton put premium; the geometric basket put
                  against the Bermudan tree at its effective GBM (max(4 SE,
                  0.5%)); the arithmetic basket's r = 0 put and q = 0 call
                  against the same-path European (max(3 SE, 0.5%)).
25. train-heston-american, resume-heston-american, serve-heston-american —
                  phases 4-6 for a Heston American put (10 inputs, the
                  production batch and head, normalization none, the
                  two-state backward: lsmc_backward_version 4 and no torch
                  estimator call, stream american_heston v2) with the step's
                  peak memory; calls NaN.
26. families-american-dynamics — one step at batch 64 each: a Merton put and
                  a geometric basket put (the single-state backward, version
                  3), an arithmetic 3-asset basket put and a Heston call
                  (served in .call; the two-state backward, version 4),
                  Heston cross-fit (the torch estimator, version 0, its one
                  call counted), an antithetic Merton put, and a Heston put
                  at 4,194,304 paths a contract, batch 4 (the two-state
                  backward's streamed route); a curved-rate Heston American
                  config refused with the JAX package's field, value and
                  reason.
27. checkpoint-store — for the TERMINAL pricer of phases 4-6, the American
                  put of phase 20 and the Heston American put of phase 25:
                  the snapshot serialized (bytes, sha256, encode and decode
                  ms, the torch_env read back), its stream and backward
                  versions read back; a flipped byte refused with
                  ChecksumMismatch and the stream version one lower refused
                  mid-stream by create; the bytes committed as the genesis of
                  a FileSystemObjectStore chain in a temporary directory and
                  served through InferenceClient(PinnedMode) bit-equal to the
                  pricer at N = 1, 7, 64; 2 train steps resumed from the
                  bytes, bit-equal to 2 resumed from the in-memory snapshot,
                  the second committed through FinalCommit and
                  make_commit_fn, the path's kernels launched twice a chunk;
                  the chain verified; the head served through
                  InferenceClient(TrackingMode) bit-equal to the in-memory
                  resume. Host-clock commit and load ms beside the card's
                  name and power limit.
28. train-loop  — the TERMINAL pricer's snapshot (after phases 4-6), 5 steps
                  at the production batch on the "cuda" engine: under
                  FinalAndIntervalCommit(2) into a FileSystemObjectStore
                  chain through make_commit_fn (segments [2, 2, 1], start
                  steps 1, 3, 5 past the snapshot's, commits at 2, 4, 5, the
                  chain verified, the step and segment callbacks' losses
                  bit-equal to the result's); under NoCommit (losses and
                  gradient norms bit-equal); through train_via_effects,
                  plainly and from inside a running event loop (losses
                  bit-equal, the same commit messages and checkpoint bytes);
                  under a warmup-cosine lr_schedule (the reported rates equal
                  schedule_rates); kernel #1 launched twice a step in each of
                  these five runs; a NaN planted in a weight of a copy of the
                  snapshot (NonFiniteLoss at the first segment's end, the
                  pricer's state as before); 2 steps with profile_dir (the
                  trace's size, its gbm_paths kernel events, one
                  train_segment range a segment); utils/flops.py's FLOPs a
                  step and the warm step's MFU against the H100's float32
                  peak; host-clock warm steps under NoCommit and
                  IntervalCommit(1) and the segment-start copy, beside the
                  card's name and power limit.
29. greeks      — the Greeks on the card at the production shape (2048 x 512
                  paths, 16 steps), after phase 28: mc_greeks on the "cuda"
                  engine for a TERMINAL put and call (kernel #1 three times a
                  call, the engine recorded "cuda"; price, delta, vega, rho
                  and theta within 2% (abs 0.01) of analytic_greeks, gamma
                  within 5%), the Function's backward on #1's samples against
                  the same rule on the twin's (same Philox words, rtol 2e-5)
                  and its CUDA ms beside the forward's, a TERMINAL
                  bump_greeks in one launch at C = 13 whose h = 0 row is the
                  base's bit for bit, BlackScholes.price_to_host within 4 SE
                  of Black with the skip advanced; a curved put (kernel #2
                  three times; within 4% (abs 0.006) of autograd through
                  term_effective_black; the rule on #2's samples equal to the
                  twin's bit for bit); the SOBOL_BB geometric-Asian call
                  (kernel #14 six times: three forwards and three backward
                  launches at (0, 0, 1); within 1% (abs 0.002) of the closed
                  form; walk_acc's gradient within rtol 1e-4 of autograd
                  through the scan over qmc_effective_normals); an up-and-out
                  call's bump_greeks and knock_in_price on "xla" within 4 SE
                  of the discrete-barrier oracle's same differences; and
                  predict_greeks on the TERMINAL pricer of phases 4-6 at N =
                  1, 7, 64 (prices equal to predict_price's, the parity
                  identity on the Jacobians, finite gammas, host-clock p50).
30. sharded     — after phase 29, the port's sharded training (parallel/):
                  (a) every forward kernel on the sharded path (#1 in each
                  branch, antithetic and Euler too, #2, #3, #5, #7, #9, the
                  QMC bridge #13 at F = 2 and walk #14 through the engine's
                  simulator; the monitor kernels #4, #6, #8, #10 through
                  their wrapper, antithetic) at the contracts its main path
                  launches, split into 2 and into 4 row shards at their
                  offsets: each shard bit-equal to the full launch's rows;
                  (b) a (1, 1) mesh over nccl in this process, TERMINAL at
                  phase 4's configuration for 1 + 3 steps: losses within
                  rtol 1e-6 of the unsharded run (bit-equality printed);
                  (c) four gloo ranks on cuda:0, spawned after the build,
                  on a (2, 2) mesh: 4 steps under FinalAndIntervalCommit(2)
                  with the commit hook through coordinator_only into a
                  filesystem chain in a temporary directory, losses within
                  rtol 2e-4 of the unsharded run, every rank's replica
                  bytes equal, the chain verified and its head served
                  through InferenceClient bit-equal to rank 0's prices;
                  (d) two ranks on a (1, 2) mesh with the American put of
                  phase 20: lsmc_backward_version 0 (the torch estimator
                  on every chunk, no CUDA backward), losses within rtol
                  5e-3 of one process (the gap printed). A rank that fails
                  fails the phase. Printed beside the card's name and power
                  limit: the warm sharded step (median of 3, host clock),
                  the all-reduce ms a step (CUDA events around every
                  torch.distributed.all_reduce) and each rank's start-up
                  seconds; several ranks on one card test the wiring, not
                  scaling.
31. entry-points — after phase 30, the user entry points around the
                  package: (a) each of examples/torch/01-13 through its
                  ``run`` on the card at the JAX example's sizes (06 as four
                  gloo ranks on cuda:0 at (2, 2), 08 as two; nccl where the
                  machine has a card a rank), each held to this script's gate
                  for its quantity — 01 put and call within 4 SE of Black;
                  02's puts within 3% of Black, 07's and 12's probe within 5%
                  of the semi-analytic and series prices; 03 the chain valid
                  and a tampered artifact refused; 04 the resume from HEAD
                  bit-equal; 05 the clients' bytes the committed ones and the
                  served put equal three ways; 06 the sharded losses within
                  rtol 2e-4 of one process, replicas bit-equal; 08 one commit,
                  from rank 0; 09 within 2% (abs 0.01) of analytic_greeks,
                  gamma 5%; 10 the geometric basket within 4 SE of its closed
                  form; 11 LSMC within max(4 SE, 0.5%) of the Bermudan tree
                  and the split-sample pair around it within 4 SE, backward 3
                  recorded; 13 the curved put within 4% of
                  term_effective_black — with its seconds and the kernel
                  branches it launched, each that its path runs at least once;
                  (b) tools/torch_model_check.py at phase 4's configuration
                  (the production batch, chunk and head) for TERMINAL on
                  "cuda", the SOBOL_BB geometric Asian, the American put and
                  the Heston American put: every split schedule of 4 batches
                  through the checkpoint bytes bit-equal to the continuous run
                  (0 violations), engine and backward (3, 4) as recorded; (c)
                  the float64 threefry TERMINAL pricer: 3 steps on the card
                  and on the CPU from the same weights at 8 contracts x 64 x
                  64 paths x 4 steps, losses within rtol 1e-9; then its rows
                  halved from 64 until a production-batch step takes at most
                  2 s (the cut printed) and the model check there.
11. profile     — only with ``--profile``, after phase 30: for the TERMINAL,
                  the Asian, the Heston, the basket, the SOBOL_BB
                  geometric-Asian and the American put pricer, 10 warm train
                  steps timed on the host clock to a synchronised end, then
                  torch.profiler over 3 train steps and over 20 predict_price
                  calls at N=64 (device kernel time, busy share, launches, the
                  heaviest kernels); for the Heston American put the same,
                  its step split into the monitor kernel, the two-state
                  backward (CUDA events around each call, and its kernel's
                  device time) and the rest.

Launch counts are set to 0 just before each main path (phases 4, 7, 8, 9,
10, 15, 16, 20, 21, 25 and 26) and read just after it: the TERMINAL
branch's count comes from phases 4-6, the Asian branch's from phase 7, the
Heston TERMINAL branch's from phase 9, the basket TERMINAL branch's and the
fused walk's from phase 15, the American monitor kernel's and the resident
single-state backward's from phase 20, the streamed single-state
backward's from phase 21, the Heston monitor kernel's and the resident
two-state backward's from phase 25, the Merton and basket monitor
kernels' and the streamed two-state backward's from phase 26, and every
other branch's from phases 8, 10 and 16; phase 27 sets them to 0 again
before each resume from bytes and checks that it launched its pricer's
kernels, and phase 28 before the training loop's runs, each of which it
checks launched kernel #1 twice a step; phase 29 sets them to 0 again and
adds its own launches of #1, #2 and #14 to their records; phase 30 adds the
launches of #1 on its (1, 1) nccl mesh (counts set to 0 just before) and on
each gloo rank, and of #4 on the American ranks (each rank counts from 0);
phase 31 sets them to 0 before each example and each model check and adds
what it launched (the ranks of examples 06 and 08 count in their own
processes). The last lines are the kernel record as JSON, the nvidia-smi
line, and the result JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import importlib.util
import inspect
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

from pathlib import Path

import numpy as np
import torch

from spectralmc_tpu_torch.core.errors.serialization import ChecksumMismatch
from spectralmc_tpu_torch.core.errors.storage import ChecksumError as StoreChecksumError
from spectralmc_tpu_torch.core.precision import Precision
from spectralmc_tpu_torch.models.factory import (
    Activation,
    CovBNCfg,
    LinearCfg,
    ResidualCfg,
    SequentialCfg,
    build_cvnn_config,
)
from spectralmc_tpu_torch.ops import (
    american,
    american_cuda,
    analytic,
    basket_cuda,
    dynamics_cuda,
    gbm_cuda,
    greeks,
    qmc,
    qmc_cuda,
    rng,
)
from spectralmc_tpu_torch.ops._build import find_nvcc, load_library
from spectralmc_tpu_torch.ops.basket import build_basket_spec, geometric_basket_effective_gbm
from spectralmc_tpu_torch.ops.dispatch import make_mean_target, make_underlier_simulator
from spectralmc_tpu_torch.ops.gbm import (
    AMERICAN_PAYOFFS,
    BARRIER_PAYOFFS,
    LOOKBACK_PAYOFFS,
    BlackScholes,
    BlackScholesContract,
    ModelKind,
    PathScheme,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    SimulationParams,
    TermStructure,
    build_simulation_params,
    curved,
    expected_underlier_mean,
    has_closed_form_mean,
    simulate_terminal_rows,
    terminal_to_prices,
)
from spectralmc_tpu_torch.ops.heston import HestonContract, heston_call_price
from spectralmc_tpu_torch.ops.merton import MertonContract, merton_call_price
from spectralmc_tpu_torch.ops.sobol import BoundSpec, SobolConfig, SobolSampler
from spectralmc_tpu_torch.runtime.torch_runtime import get_torch_handle
from spectralmc_tpu_torch.serialization import deserialize_checkpoint, serialize_checkpoint
from spectralmc_tpu_torch.storage import (
    AsyncBlockchainModelStore,
    ChainValid,
    FileSystemObjectStore,
    InferenceClient,
    PinnedMode,
    TrackingMode,
    make_commit_fn,
    verify_chain_detailed,
)
from spectralmc_tpu_torch.training.adam_state import AdamState
from spectralmc_tpu_torch.training.step import LRScheduleConfig, model_params, schedule_rates
from spectralmc_tpu_torch.training.trainer import (
    FinalAndIntervalCommit,
    FinalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    IntervalCommit,
    SegmentStart,
    build_training_config,
)
from spectralmc_tpu_torch.utils.flops import (
    fft_flops,
    mfu,
    sim_path_steps,
    train_step_matmul_flops,
)
from tools import torch_model_check

ROWS, COLS, STEPS = 2048, 512, 16
BATCH, CHUNK = 512, 256
PAYOFF_BATCH = 64
KERNEL_RTOL = 2e-5  # libm/sinpif ulps between torch ops and device intrinsics
FLIP_SHARE = 1e-5  # barrier knocks and digital signs flipped by those ulps
# Heston paths past KERNEL_RTOL: sqrt(max(v, 0)) is not Lipschitz at zero, so an
# ulp of a small variance grows from step to step. At most HESTON_SHARE of a
# case's paths may pass KERNEL_RTOL, none of them HESTON_CAP_RTOL (but a
# flipped knock or sign), and the phase prints how low their variance went
HESTON_SHARE = 5e-6
HESTON_CAP_RTOL = 1e-3
HESTON_LOW_VARIANCE = 1e-3  # "low": the path's least raw variance below this
SOURCE = "spectralmc_tpu_torch/csrc/gbm_paths.cu"
DYNAMICS_SOURCE = "spectralmc_tpu_torch/csrc/dynamics_paths.cu"
REPLACES = {"cliquet": "spectralmc_tpu/ops/gbm_pallas.py:793"}  # the rest: :512
# The kernels of csrc/dynamics_paths.cu: the TPU kernel each replaces
FAMILIES = ("term", "heston", "merton")
FAMILY_REPLACES = {
    "term": "spectralmc_tpu/ops/gbm_pallas.py:387",
    "heston": "spectralmc_tpu/ops/gbm_pallas.py:1989",
    "merton": "spectralmc_tpu/ops/gbm_pallas.py:3171",
}
FAMILY_MODEL = {"gbm": "gbm", "term": "gbm", "heston": "heston", "merton": "merton_jump",
                "basket": "basket_gbm"}
FAMILY_STREAM = {"term": "gbm_term", "heston": "heston", "merton": "merton_jump",
                 "basket": "basket_gbm"}
FAMILY_CONTRACT = {"gbm": BlackScholesContract, "term": BlackScholesContract,
                   "heston": HestonContract, "merton": MertonContract,
                   "basket": BlackScholesContract}
# The basket kernel (csrc/basket_paths.cu) and the QMC generator's two
# kernels (csrc/qmc_paths.cu), and the TPU kernels they replace
BASKET_SOURCE = "spectralmc_tpu_torch/csrc/basket_paths.cu"
BASKET_REPLACES = "spectralmc_tpu/ops/gbm_pallas.py:2484"
QMC_SOURCE = "spectralmc_tpu_torch/csrc/qmc_paths.cu"
QMC_REPLACES = {"qmc_bridge": "spectralmc_tpu/ops/qmc_pallas.py:98",
                "qmc_walk": "spectralmc_tpu/ops/qmc_pallas.py:280"}
# The JAX bench's basket (bench.py:684-688): 3 assets, arithmetic combine
BASKET_KW = dict(weights=(0.5, 0.3, 0.2),
                 correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)))
BASKET_SPEC = build_basket_spec(**BASKET_KW).expect("basket spec")
GEOMETRIC_SPEC = build_basket_spec(**BASKET_KW, combine="geometric").expect("basket spec")
QMC_SEED = 31  # the JAX bench's mc_seed for SOBOL_BB (bench.py:870)
FORWARD_STEP = 6
CLIQUET = dict(reset_every=4, floor=-0.05, cap=0.08)
CLIQUET_STEPS = (8, 12, STEPS, 20)  # 2, 3, 4 and 5 periods
BOUNDS = {
    "spot": BoundSpec(lower=80.0, upper=120.0),
    "strike": BoundSpec(lower=80.0, upper=120.0),
    "maturity": BoundSpec(lower=0.25, upper=2.0),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}
# The dynamics families' market bounds and model bounds (the JAX package's
# bench.py: Heston :535-552, Merton :597-603)
MARKET_BOUNDS = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.5, upper=1.5),
    "rate": BoundSpec(lower=0.01, upper=0.05),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
}
FAMILY_BOUNDS = {
    "gbm": BOUNDS,
    "term": BOUNDS,
    "heston": {
        **MARKET_BOUNDS,
        "v0": BoundSpec(lower=0.03, upper=0.08),
        "kappa": BoundSpec(lower=1.0, upper=2.5),
        "theta": BoundSpec(lower=0.03, upper=0.08),
        "xi": BoundSpec(lower=0.2, upper=0.5),
        "rho": BoundSpec(lower=-0.8, upper=-0.3),
    },
    "merton": {
        **MARKET_BOUNDS,
        "vol": BoundSpec(lower=0.15, upper=0.25),
        "lam": BoundSpec(lower=0.1, upper=0.8),
        "jump_mean": BoundSpec(lower=-0.15, upper=0.0),
        "jump_std": BoundSpec(lower=0.1, upper=0.25),
    },
    # the JAX bench's basket domain (bench.py:578)
    "basket": {**MARKET_BOUNDS, "vol": BoundSpec(lower=0.2, upper=0.3)},
}


def term_of(steps: int) -> TermStructure:
    """The curved market of the term kernel's phases (bench.py:982-985):
    vol falling from 1.5x to 0.5x, rate rising from 0.5x to 1.5x."""
    return TermStructure(vol_shape=tuple(1.5 - 1.0 * i / steps for i in range(steps)),
                         rate_shape=tuple(0.5 + 1.0 * i / steps for i in range(steps)))


def group_of(family: str, branch: str) -> str:
    """The launch-count and record name of a family's branch."""
    return branch if family == "gbm" else f"{family}_{branch}"


def family_of(sim: SimulationParams) -> str:
    if sim.model == ModelKind.HESTON:
        return "heston"
    if sim.model == ModelKind.MERTON_JUMP:
        return "merton"
    if sim.model == ModelKind.BASKET_GBM:
        return "basket"
    return "term" if curved(sim.term) is not None else "gbm"


def branch_of(family: str, payoff: PayoffKind, spec: object = BASKET_SPEC) -> str:
    if payoff in AMERICAN_PAYOFFS:
        return "american_gbm"  # the monitor-row kernel (its backward counts apart)
    if family == "heston" and payoff == PayoffKind.FORWARD_START:
        return "forward"  # the Heston kernel captures ln S_m in a branch of its own
    if family == "basket":
        return basket_cuda.basket_branch(payoff, spec)
    return gbm_cuda.branch_of(payoff)


# strike bounds in each payoff's own units (vol² for the variance swap,
# return units for the cliquet)
STRIKE_BOUNDS = {
    PayoffKind.VARIANCE_SWAP: BoundSpec(lower=0.02, upper=0.10),
    PayoffKind.CLIQUET: BoundSpec(lower=0.01, upper=0.08),
}
KNOBS = {
    PayoffKind.BARRIER_UP_OUT: dict(barrier_rel=1.25),
    PayoffKind.BARRIER_DOWN_OUT: dict(barrier_rel=0.8),
    PayoffKind.FORWARD_START: dict(forward_start_step=6),
    PayoffKind.CLIQUET: dict(cliquet_reset_every=CLIQUET["reset_every"],
                             cliquet_floor=CLIQUET["floor"], cliquet_cap=CLIQUET["cap"]),
}

# The least time the card could take (bound_ms): the larger of the bytes the
# function must move (24 + 8 bytes of contract and key per contract, 4 bytes
# written per path) over 3.35 TB/s, and its operations over 67 TFLOP/s (the
# H100's float32 rate outside the tensor cores; integer and transcendental
# operations counted one each at that rate). Per path: the Philox round keys
# (9 rounds' two key additions: 18), a function of the contract's key only.
# Per draw: half a Philox call (10 rounds of 2 mul-hi, 2 mul-lo, 4 xor = 80
# operations per call), the two uniforms (shift, convert, fma each), log,
# mul, sqrt and the sine or cosine with its argument: 50. Per unit of the
# branch's loop (a path-step, or a period for the cliquet): the state update
# and the branch's own work.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The instruction cap (share_of_instruction_cap): one warp instruction per scheduler per
# clock, 132 SMs x 4 schedulers x 32 lanes, at the card's maximum SM clock,
# over the SASS instructions one path-step of the log-Euler loop executes.
LANES_PER_CLOCK = 132 * 4 * 32
PHILOX_KEY_OPS = 18
DRAW_OPS = 50
UNIT_OPS = {"terminal": 3, "barrier": 4, "lookback": 4, "variance": 4, "asian": 5, "cliquet": 8,
            "forward": 4}
# The term kernel draws as the flat kernel does and loads one table entry per
# step: one more operation per unit; its table adds 8 bytes per step to each
# contract's input. A Heston step is one
# draw with a second trigonometric output (1) plus z_s (3), v+ (1), the fused
# root (2), the log-price update (6) and the variance update (6): 19 on top of
# the draw, in place of the flat update's 3. A Merton step needs three of a
# Philox call's four words (60), three uniforms (9), log, mul, sqrt, the
# sincos pair and its argument (6), a count over 16 sorted levels (log2(16) =
# 4 compares), the jump (5) and the pair's products (4): 88, then the
# log-price update (4) in place of the flat 3; its level table adds 64 bytes
# per contract. The kernel reads exactly those three words a step (four steps
# on three calls) and compares kCountFirst levels, the rest behind a branch
# its inputs here almost never take.
HESTON_STEP_OPS = 19
MERTON_STEP_OPS = 88


def phase(label: str, **findings: object) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in findings.items()), flush=True)


def cuda_ms(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cap_share(rate: float, cap: float, key: str = "share_of_instruction_cap") -> dict[str, object]:
    """``{key: share}`` of the SASS instruction cap a kernel reached (``rate``
    over ``cap``, both per second); a share above 1 cannot be read — the
    count took instructions the loop does not issue — and is printed as
    null with that reason."""
    share = rate / cap
    if share <= 1.0:
        return {key: f"{share:.4f}"}
    return {key: None, f"{key}_unread": "the SASS count takes instructions the loop does not "
            "issue (the measured rate passes the cap it implies)"}


def bound_ms(group: str, contracts: int, steps: int) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of one launch of a branch group at
    ``contracts x ROWS x COLS`` over ``steps`` log-Euler steps (the op model
    in the module header)."""
    family, _, branch = group.rpartition("_")
    family = family or "gbm"
    paths = contracts * ROWS * COLS
    units = steps // CLIQUET["reset_every"] if branch == "cliquet" else steps
    paired = family in ("gbm", "term") and branch in ("terminal", "variance", "cliquet")
    draws = -(-units // 2) if paired else units
    byte_count = contracts * (4 * len(FAMILY_CONTRACT[family].model_fields) + 8) + paths * 4
    if family == "merton":
        ops = paths * (PHILOX_KEY_OPS + units * (MERTON_STEP_OPS + UNIT_OPS[branch] + 1))
        byte_count += contracts * 64
    elif family == "heston":
        ops = paths * (PHILOX_KEY_OPS + units * (DRAW_OPS + HESTON_STEP_OPS + UNIT_OPS[branch]))
    else:
        per_unit = UNIT_OPS[branch] + (1 if family == "term" else 0)
        ops = paths * (PHILOX_KEY_OPS + draws * DRAW_OPS + units * per_unit)
        if family == "term":
            byte_count += contracts * 8 * steps
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# The basket kernel's op model per path-step of A assets: ⌈A/2⌉ draws
# (DRAW_OPS each, plus 2 for the second trigonometric output and its product
# where a second asset reads it: ⌊A/2⌋ of them), the Cholesky mix (A(A+1)/2 multiply-adds), the A state updates (2
# each) and what the branch reads each step: the basket value (arithmetic:
# A exp and A multiply-adds; geometric: A multiply-adds and one exp) and one
# more operation (max, min or add; the geometric Asian a log besides); the
# variance swap its step log-return (geometric: A multiply-adds; arithmetic:
# the value, a division and a log) and a multiply-add. TERMINAL and the
# forward start read the value once per path. A path moves 32 bytes in and 4
# out; the spec travels as a kernel argument.
def basket_step_ops(assets: int, branch: str, geometric: bool, variant: int = 0) -> int:
    ops = ((assets + 1) // 2 * DRAW_OPS + assets // 2 * 2
           + assets * (assets + 1) // 2 + 2 * assets)
    value = assets + 1 if geometric else 2 * assets
    if branch in ("barrier", "lookback"):
        ops += value + 1
    elif branch == "asian":
        ops += value + 1 + variant
    elif branch == "variance":
        ops += (assets if geometric else value + 2) + 1
    return ops


def basket_bound_ms(contracts: int, steps: int, assets: int, branch: str,
                    geometric: bool, variant: int = 0) -> tuple[float, str]:
    paths = contracts * ROWS * COLS
    ops = paths * (PHILOX_KEY_OPS + steps * basket_step_ops(assets, branch, geometric, variant))
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = (contracts * 32 + paths * 4) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# The QMC generator's op model per point and flat dimension: the word (one
# XOR: the gray-code step from the previous point), the inverse CDF (the
# 24-bit uniform: 4; erf⁻¹: x², log1p, the branch's 8 multiply-adds and the
# final products: 13), and the bridge product's multiply-adds, counted over
# the bridge matrix's nonzeros only (what this run's data needs); the walk
# adds 4 per step. Bytes: the output (T·F floats per point for the bridge
# kernel, one for the walk), the padded normals read, the tables.
QMC_WORD_OPS, QMC_NORMAL_OPS, WALK_STEP_OPS = 1, 17, 4


def qmc_bound_ms(contracts: int, steps: int, factors: int, count: int,
                 walk: bool = False) -> tuple[float, str]:
    sdims = qmc.qmc_sobol_dims(steps, factors)
    nnz = int(np.count_nonzero(qmc.brownian_bridge_matrix(steps)))
    per_point = (sdims * (QMC_WORD_OPS + QMC_NORMAL_OPS) + factors * nnz
                 + (steps * WALK_STEP_OPS if walk else 0))
    t_ops = contracts * count * per_point / FP32_OPS_PER_S * 1e3
    out = count * (1 if walk else steps * factors) * 4
    pad = count * (steps * factors - sdims) * 4
    tables = sdims * 33 * 4 + steps * steps * 4
    t_bytes = (contracts * (out + pad) + tables) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------------------
# 0-1. device and build
# --------------------------------------------------------------------------


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[torch.device, str, float]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    smi = nvidia_smi("name,power.limit")
    max_sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    runtime = get_torch_handle()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), clocks_max_sm_mhz=max_sm_hz / 1e6, torch=torch.__version__,
          cuda=runtime.cuda_version)
    return torch.device("cuda", 0), smi, max_sm_hz


def phase_build() -> tuple[dict[str, float], tuple[float, str], dict[str, tuple[float, str]],
                           dict[str, tuple[float, str]], dict[str, object]]:
    """Build the eight kernel libraries, one nvcc each, all started together,
    and count their loops' SASS instructions per path-step, per branch group
    and for the American monitor kernels, the LSMC backward's 16-path block
    per path, and the fused QMC walk's per point."""
    from concurrent.futures import ThreadPoolExecutor

    libraries = ((SOURCE, gbm_cuda.LIBRARY), (DYNAMICS_SOURCE, dynamics_cuda.LIBRARY),
                 (BASKET_SOURCE, basket_cuda.LIBRARY), (QMC_SOURCE, qmc_cuda.LIBRARY),
                 (AMERICAN_SOURCE, american_cuda.LIBRARY),
                 (DYNAMICS_AMERICAN_SOURCE, american_cuda.DYNAMICS_LIBRARY),
                 ("spectralmc_tpu_torch/csrc/lsmc_backward.cu", american_cuda.BACKWARD_LIBRARY),
                 ("spectralmc_tpu_torch/csrc/lsmc_two_state.cu", american_cuda.TWO_STATE_LIBRARY))
    start = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: load_library(*lib[1]), libraries))
    wall = time.perf_counter() - start
    for (source, _), lib in zip(libraries, built):
        phase("build", source=source, library=lib.path.name,
              build_seconds=f"{lib.build_seconds:.2f}", all_builds_wall_s=f"{wall:.2f}",
              registers_and_spill_bytes=ptxas_summary(lib.log))
    logs = {name: text for lib in built for name, text in ptxas_summary(lib.log).items()}
    phase("occupancy", threads_per_block=PATH_THREADS, limit="registers (no shared memory)",
          **{name: f"{register_occupancy(logs[name]):.4f}" for name in OCCUPANCY_KERNELS
             if name in logs})
    dynamics = dynamics_sass_per_step(built[5].path)
    phase("sass-american-dynamics", **{case: f"{n:g} ({found})" for case, (n, found)
                                        in dynamics.items()})
    american_sass_split(built[4].path, built[5].path)
    lsmc = {name: lsmc_sass_per_path_date(built[7 if two else 6].path, two,
                                          not name.endswith("_streamed"))
            for name in LSMC_REPLACES for two in [name.startswith("lsmc_two_state")]}
    phase("sass-lsmc", degree=LSMC_DEGREE,
          **{name: f"{n:g} ({found})" for name, (n, found) in lsmc.items()})
    try:  # a measurement only: a toolkit without nvdisasm or line info prints why
        qmc_sass = qmc_walk_sass(built[3].path)
    except (AssertionError, OSError, StopIteration, ValueError,
            subprocess.CalledProcessError) as err:
        qmc_sass = {"error": repr(err)[:300]}
    phase("sass-split", kernel="qmc_walk", parts="per point", timesteps=STEPS, **qmc_sass)
    try:
        bridge_sass = qmc_bridge_sass(built[3].path)
    except (AssertionError, OSError, StopIteration, ValueError,
            subprocess.CalledProcessError) as err:
        bridge_sass = {"error": repr(err)[:300]}
    phase("sass-split", kernel="qmc_bridge", parts="per point and factor", timesteps=STEPS,
          factors=1, **bridge_sass)
    qmc_sass = dict(qmc_sass, bridge=bridge_sass)
    return (sass_instruction_counts(built[0].path, built[1].path, built[2].path),
            american_sass_per_step(built[4].path), dynamics, lsmc, qmc_sass)


# The path kernels' theoretical occupancy from their registers: a block of
# PATH_THREADS threads (csrc's kThreads), registers allocated per warp in
# units of 256, at most 64 warps, 32 blocks and 65,536 registers an SM.
PATH_THREADS = 256
OCCUPANCY_KERNELS = ("gbm_paths_kernel<0,0,0>", "gbm_paths_kernel<4,0,0>", "heston_paths_kernel<0>",
                     "basket_paths_kernel<3,0,0>", "american_heston_kernel",
                     "american_basket_kernel<3,0>", "qmc_walk_sparse_kernel<16>")


def register_occupancy(summary: str) -> float:
    """Resident warps over 64 for a ``ptxas_summary`` entry."""
    regs = int(summary.split()[0])
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 2048 // PATH_THREADS, 65536 // (per_warp * PATH_THREADS // 32))
    return blocks * PATH_THREADS / 32 / 64


def ptxas_summary(log: str) -> dict[str, str]:
    """``{kernel<family>: "N registers, S spill bytes"}`` from the output of
    ``nvcc -Xptxas -v`` (empty when an existing build was reused)."""
    kernel = (r"(gbm_paths_kernel|gbm_cliquet_kernel|gbm_term_kernel|heston_paths_kernel|"
              r"merton_paths_kernel|basket_paths_kernel|qmc_bridge_kernel|qmc_walk_kernel|"
              r"qmc_walk_sparse_kernel|qmc_bridge_sparse_kernel|"
              r"american_gbm_kernel|backward_kernel|"
              r"american_heston_kernel|american_merton_kernel|american_basket_kernel)"
              r"(?:ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?(?:Lb(\d)E)?)?")
    found, name, spill = {}, None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?" + kernel, line)
        if entry:
            args = ",".join(g for g in entry.groups()[1:] if g)
            name = entry.group(1) + (f"<{args}>" if args else "")
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spilled:
            spill = int(spilled.group(1)) + int(spilled.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name] = f"{used.group(1)} registers, {spill} spill bytes"
            name = None
    return found


def cuobjdump_sass(library: object) -> str:
    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout


def sass_instruction_counts(flat: object, dynamics: object, basket: object) -> dict[str, float]:
    """SASS instructions one log-Euler path-step executes, per branch group,
    counted from ``cuobjdump -sass`` of the built libraries.

    The flat kernel's log-Euler instantiations (``gbm_paths_kernel<family,
    0>``) walk whole Philox calls, unskipped: an iteration covers the steps
    its calls' draws feed (``loop_weights``; a pair-step draw, TERMINAL's and
    the variance swap's, feeds two), and so do the term kernel's
    (``term_sass_count``). A build whose instantiation holds both
    schemes' loops and draws one by one (the rolled draw) is counted by the
    rolled rule: the log-Euler loop is the last
    loop whose body takes no absolute value (the Euler loop's reflection); of
    its N instructions, the Philox block (a skipped region with >= 16
    high-half products, PHILOX_MULTIPLY) runs every other iteration, a slow
    path holding a CALL (sqrtf's fix-up) never on these inputs, and any other
    skipped region is the branch's once-per-path single step (TERMINAL,
    variance: subtracted) or the arithmetic Asian's ``expf`` (kept);
    per path-step: that over the steps an iteration covers (2 for the
    pair-steps, else 1). The cliquet kernel is counted over a whole path
    (``cliquet_sass_count``: its walk, four periods a call, and the code a
    path runs once, over the steps). The
    term and Heston kernels have one loop each (the longest). The Heston
    kernel and the basket kernel's 3-asset arithmetic instantiations (one
    loop each, the longest) walk whole Philox calls; the basket forward
    start's capture of B_m runs once per path (subtracted). The Merton kernel
    walks three words a step (MERTON_DRAWS_PER_STEP draws: four steps on
    three calls an iteration, the loop that walks whole calls); its count's
    rare branch (the levels past the first, taken about once in 10^6 steps
    at the bench's rates) is a skipped region that never runs on these
    inputs (subtracted, as sqrtf's fix-up is), and so is any other that does
    not end by jumping over an else arm.
    """
    flat_sass = cuobjdump_sass(flat)
    if FLAT_WALKS["terminal"] in flat_sass:  # the walks, one loop an instantiation
        counts, found = parse_instruction_counts(
            flat_sass, {piece: b for b, piece in FLAT_WALKS.items()},
            {}, pick_loop=walk_or_longest, single_step=lambda group: False,
            draws_per_step=FLAT_DRAWS_PER_STEP)
    else:
        counts, found = parse_instruction_counts(
            flat_sass, {f"gbm_paths_kernelILi{code}E": b
                        for b, code in gbm_cuda._FAMILY_CODE.items()},
            {"terminal": 2, "variance": 2}, pick_loop=last_loop_without_abs,
            single_step=lambda group: group != "asian")
    more, found_more = cliquet_sass_count(flat_sass)
    counts.update(more)
    found.update(found_more)
    codes = {**gbm_cuda._FAMILY_CODE, "forward": 5}
    dynamics_sass = cuobjdump_sass(dynamics)
    more, found_more = term_sass_count(dynamics_sass)
    counts.update(more)
    found.update(found_more)
    heston_kernels = {f"heston_paths_kernelILi{code}E": f"heston_{branch}"
                      for branch, code in codes.items()}
    more, found_more = parse_instruction_counts(
        dynamics_sass, heston_kernels, {}, pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: False,
        draws_per_step=dict.fromkeys(heston_kernels.values(), 1))
    counts.update(more)
    found.update(found_more)
    merton_kernels = {f"merton_paths_kernelILi{code}E": f"merton_{branch}"
                      for branch, code in gbm_cuda._FAMILY_CODE.items()}
    more, found_more = parse_instruction_counts(
        dynamics_sass, merton_kernels, {}, pick_loop=walk_or_longest,
        single_step=lambda group: True,
        draws_per_step=dict.fromkeys(merton_kernels.values(), MERTON_DRAWS_PER_STEP))
    counts.update(more)
    found.update(found_more)
    basket_kernels = {f"basket_paths_kernelILi3ELi{code}ELb0E": f"basket_{branch}"
                      for branch, code in codes.items()}  # the 3-asset arithmetic basket
    basket_sass = cuobjdump_sass(basket)
    more, found_more = parse_instruction_counts(
        basket_sass, basket_kernels, {}, pick_loop=lambda loops: max(loops, key=len),
        single_step=lambda group: group == "basket_forward",
        draws_per_step=dict.fromkeys(basket_kernels.values(), 2))
    counts.update(more)
    found.update(found_more)
    phase("sass", log_euler_loop=repr(found),
          instructions_per_path_step={b: round(c, 3) for b, c in counts.items()})
    flat_disasm = None
    for kernel, sass, library, piece, draws, pick in (
            ("gbm_terminal", flat_sass, flat, FLAT_WALKS["terminal"], 0.5, walk_loop),
            ("gbm_asian", flat_sass, flat, FLAT_WALKS["asian"], 1, walk_loop),
            ("term_terminal", dynamics_sass, dynamics, "gbm_term_kernelILi0E", 0.5, walk_loop),
            ("heston_terminal", dynamics_sass, dynamics, "heston_paths_kernelILi0E", 1, None),
            ("merton_terminal", dynamics_sass, dynamics, "merton_paths_kernelILi0E",
             MERTON_DRAWS_PER_STEP, walk_or_longest),
            ("basket3_arithmetic_terminal", basket_sass, basket,
             "basket_paths_kernelILi3ELi0ELb0E", 2, None)):
        try:  # a measurement only: a toolkit without nvdisasm or line info prints why
            if library is flat and flat_disasm is None:
                flat_disasm = nvdisasm_text(flat)
            disasm = flat_disasm if library is flat else nvdisasm_text(library)
            split = sass_split(sass, disasm, piece, draws_per_step=draws, pick_loop=pick,
                               single_step=kernel.startswith("merton_"))
        except (AssertionError, OSError, StopIteration, ValueError,
                subprocess.CalledProcessError) as err:
            split = {"error": repr(err)[:300]}
        phase("sass-split", kernel=kernel, parts="per path-step", **split)
    try:
        if flat_disasm is None:
            flat_disasm = nvdisasm_text(flat)
        split = cliquet_sass_split(flat_sass, flat_disasm)
    except (AssertionError, OSError, StopIteration, ValueError,
            subprocess.CalledProcessError) as err:
        split = {"error": repr(err)[:300]}
    phase("sass-split", kernel="cliquet", parts="per path", timesteps=STEPS, **split)
    return counts


# The term kernel walks whole Philox calls (gbm_term v2): its TERMINAL and
# variance-swap loops feed four steps a call (a pair draw advances two), its
# one-draw branches two; a build that draws one by one (v1) has one loop per
# instantiation, the longest, over the steps its draws feed (two for a pair).
TERM_KERNELS = {f"gbm_term_kernelILi{code}E": f"term_{branch}"
                for branch, code in gbm_cuda._FAMILY_CODE.items()}


def term_sass_count(text: str) -> tuple[dict[str, float], dict[str, str]]:
    """``parse_instruction_counts`` for the term kernel's five instantiations
    in ``cuobjdump -sass`` text: per path-step of each branch group."""
    if any(walks(body) for body in sass_loops(text, "gbm_term_kernelILi0E")):
        return parse_instruction_counts(
            text, TERM_KERNELS, {}, pick_loop=walk_or_longest, single_step=lambda group: False,
            draws_per_step={g: FLAT_DRAWS_PER_STEP[g[len("term_"):]]
                            for g in TERM_KERNELS.values()})
    return parse_instruction_counts(
        text, TERM_KERNELS, {"term_terminal": 2, "term_variance": 2},
        pick_loop=lambda loops: max(loops, key=len), single_step=lambda group: False)


def cliquet_sass_count(text: str, steps: int = STEPS) -> tuple[dict[str, float], dict[str, str]]:
    """The cliquet kernel's SASS per path-step in ``cuobjdump -sass`` text,
    over a whole path of ``steps`` steps (``cliquet_path_weights``: its loop
    over the periods and the code a path runs once, over the steps)."""
    block = next(b for b in text.split("Function : ")[1:]
                 if "gbm_cliquet_kernel" in b.split()[0])
    weights, info = cliquet_path_weights(block, steps)
    found = f"{info['loop']} x {info['iterations']:g} + {info['outside_loop']}"
    return {"cliquet": sum(w for _, _, w in weights) / steps}, {"cliquet": found}


# draws a path-step of each flat log-Euler branch takes: a pair-step draw
# (TERMINAL, the variance swap) advances two steps
FLAT_DRAWS_PER_STEP = {"terminal": 0.5, "variance": 0.5, "barrier": 1, "lookback": 1, "asian": 1}
# a Merton step reads three words, one and a half draws of two
MERTON_DRAWS_PER_STEP = 1.5
# each branch group's log-Euler instantiation (gbm_paths_kernel<family, 0,
# step rule>) at its timed payoff (TIMED_PAYOFF): the up-and-out barrier and
# the fixed lookback call track a maximum, the arithmetic Asian sums prices
FLAT_WALKS = {"terminal": "gbm_paths_kernelILi0ELi0ELb0E",
              "barrier": "gbm_paths_kernelILi1ELi0ELb1E",
              "lookback": "gbm_paths_kernelILi2ELi0ELb1E",
              "variance": "gbm_paths_kernelILi3ELi0ELb0E",
              "asian": "gbm_paths_kernelILi4ELi0ELb0E"}


SASS_LINE = r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;"
# a Philox round's high-half products: IMAD.WIDE.U32, or IMAD.HI.U32 beside
# a plain IMAD where ptxas splits one
PHILOX_MULTIPLY = r"\bIMAD\.(WIDE\.U32|HI\.U32)\b"
SASS_BRANCH = r"\bBRA (?:!?P\d, )?0x([0-9a-f]+)"


def last_loop_without_abs(loops: list[list[tuple[int, str]]]) -> list[tuple[int, str]]:
    return [body for body in loops
            if not any(re.search(r"\|R\d+\|", op) and not op.startswith("FSETP")
                       for _, op in body)][-1]


def block_instructions(block: str) -> list[tuple[int, str]]:
    """``[(address, instruction)]`` of one function's ``cuobjdump -sass`` text."""
    return [(int(a, 16), op.strip()) for a, op in re.findall(SASS_LINE, block)]


def block_loops(block: str) -> list[list[tuple[int, str]]]:
    """Every loop of one function's ``cuobjdump -sass`` text: the
    instructions from a backward branch's target to the branch."""
    ins = block_instructions(block)
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (addr, op) in enumerate(ins):
        back = re.search(SASS_BRANCH, op)
        if back and int(back.group(1), 16) < addr and int(back.group(1), 16) in at:
            loops.append(ins[at[int(back.group(1), 16)]:i + 1])
    return loops


def sass_loops(text: str, piece: str) -> list[list[tuple[int, str]]]:
    """``block_loops`` of the first function in ``cuobjdump -sass`` text whose
    mangled name holds ``piece`` (none where no function does)."""
    block = next((b for b in text.split("Function : ")[1:] if piece in b.split()[0]), None)
    return [] if block is None else block_loops(block)


def loop_weights(
    block: str, group: str, *, pick_loop: object, single_step: object,
    steps_per_iteration: int = 1, draws_per_step: int | None = None,
) -> tuple[list[tuple[int, str, float]], int, str]:
    """``(weights, steps, found)`` of one kernel's step loop in the text of
    ``cuobjdump -sass`` (``block``: one function's): each instruction of the
    loop body with the share of iterations it runs in (a skipped Philox
    block ½, a slow path holding a CALL — shorter than half the body: a
    longer region is the step itself behind the loop's guard — and, where
    ``single_step(group)``,
    another skipped region 0, the rest 1), the path-steps an iteration
    covers and the count's derivation. Where ``draws_per_step`` is given (a
    kernel that walks its draws in whole calls; ½ where a draw advances two
    steps) and the body calls Philox unskipped, an iteration covers
    ``2 · calls / draws_per_step`` steps,
    calls being its high-half multiplies (PHILOX_MULTIPLY) over the 20 of a
    call, else ``steps_per_iteration``; there a region that ends by jumping
    over an else arm is one side of a two-way branch (the Box–Muller's
    ``u1 < ½``, divergent: both sides issue), never a once-per-path one."""
    loops = block_loops(block)
    if not loops:
        raise AssertionError(f"no loop found in the SASS of {group}")
    body = pick_loop(loops)
    share = {a: 1.0 for a, _ in body}
    idle, switches = argument_switches(body, body[0][0], body[-1][0] + 1)
    philox = calls = single = 0
    for addr, op in body:
        skip = re.search(SASS_BRANCH, op)
        if not (skip and op.startswith("@") and addr < int(skip.group(1), 16) <= body[-1][0]):
            continue
        if addr in idle or addr in switches:
            continue
        inside = [a for a, o in body if addr < a < int(skip.group(1), 16)]
        region = [o for a, o in body if a in inside]
        if sum(bool(re.search(PHILOX_MULTIPLY, o)) for o in region) >= 16:
            philox += len(region)
            share.update(dict.fromkeys(inside, 0.5))
        elif any("CALL" in o for o in region) and len(region) < len(body) // 2:
            calls += len(region)
            share.update(dict.fromkeys(inside, 0.0))
        elif single_step(group) and not (draws_per_step and region and
                                         region[-1].startswith("BRA")):
            single += len(region)
            share.update(dict.fromkeys(inside, 0.0))
    share.update(dict.fromkeys(idle, 0.0))
    steps = steps_per_iteration
    unskipped = sum(bool(re.search(PHILOX_MULTIPLY, op)) for a, op in body if share[a] == 1.0)
    if draws_per_step and not philox and unskipped >= 16:
        steps = round(round(unskipped / 20) * 2 / draws_per_step)
    per_iteration = len(body) - calls - single - philox / 2 - len(idle)
    found = (f"{len(body)}-{calls}-{single}-{philox}/2" + (f"-{len(idle)}" if idle else "")
             + f"={per_iteration:g}/{steps}")
    return [(a, op, share[a]) for a, op in body], steps, found


# A two-way branch on a kernel argument: the compare that sets its predicate
# reads registers the loop last loaded from the parameter bank (c[0x0]),
# which ptxas reloads in the loop where it reuses the register, or uniform
# registers (one value a warp) the loop never writes.
KERNEL_ARGUMENT = r"^U?LDC(?:\.\w+)? (U?R\d+), c\[0x0\]"
DESTINATION = r"^(?:@!?U?P\w+ )?[A-Z][\w.]* ((?:U?P|U?R)\w+)\b"


def on_kernel_argument(body: list[tuple[int, str]], index: int) -> bool:
    """Whether the conditional branch ``body[index]`` tests a kernel
    argument (KERNEL_ARGUMENT), so every thread of a launch takes one arm
    on every iteration."""
    predicate = re.match(r"@!?(P\d+) BRA ", body[index][1])
    if predicate is None:
        return False

    def last_write(reg: str, before: int) -> int | None:
        return next((j for j in range(before - 1, -1, -1)
                     if (d := re.match(DESTINATION, body[j][1])) and d.group(1) == reg), None)

    def invariant(reg: str, before: int) -> bool:
        load = last_write(reg, before)
        if load is not None:
            return bool(re.match(KERNEL_ARGUMENT, body[load][1]))
        return reg.startswith("UR") and last_write(reg, len(body)) is None

    compare = last_write(predicate.group(1), index)
    if compare is None:
        return False
    regs = re.findall(r"\bU?R\d+\b", body[compare][1].split(",", 1)[-1])
    return bool(regs) and all(invariant(reg, compare) for reg in regs)


def argument_switches(body: list[tuple[int, str]], lo: int, hi: int) -> tuple[set[int], set[int]]:
    """``(idle, switches)`` in the addresses ``[lo, hi)`` of a loop body:
    each if/else on a kernel argument (``on_kernel_argument``; the then arm
    ends by jumping over the else arm) runs one arm, the longer one counted
    and the other idle (its addresses), arms nested in arms alike; the
    switches are those branches' addresses."""
    at = {a: i for i, (a, _) in enumerate(body)}
    idle: set[int] = set()
    switches: set[int] = set()
    i = next((k for k, (a, _) in enumerate(body) if a >= lo), len(body))
    while i < len(body) and body[i][0] < hi:
        addr, op = body[i]
        jump = re.search(SASS_BRANCH, op)
        target = int(jump.group(1), 16) if jump else 0
        last = at.get(target - 16) if addr < target <= hi else None
        over = re.fullmatch(r"BRA 0x([0-9a-f]+)", body[last][1]) if last is not None else None
        if op.startswith("@") and over and int(over.group(1), 16) > target \
                and on_kernel_argument(body, i):
            end = min(int(over.group(1), 16), hi)
            arms = [(addr + 1, target), (target, end)]
            inner = [argument_switches(body, a, b) for a, b in arms]
            sizes = [sum(a <= x < b and x not in sub[0] for x, _ in body)
                     for (a, b), sub in zip(arms, inner)]
            keep = 0 if sizes[0] >= sizes[1] else 1
            a, b = arms[1 - keep]
            idle |= inner[keep][0] | {x for x, _ in body if a <= x < b}
            switches |= {addr} | inner[keep][1]
            i = next((k for k, (x, _) in enumerate(body) if x >= end), len(body))
            continue
        i += 1
    return idle, switches


def parse_instruction_counts(
    text: str, kernels: dict[str, str], steps_per_iteration: dict[str, int], *,
    pick_loop: object, single_step: object, draws_per_step: dict[str, int] | None = None,
) -> tuple[dict[str, float], dict[str, str]]:
    """``sass_instruction_counts``'s rule on the text of ``cuobjdump -sass``:
    ``kernels`` maps a piece of a mangled kernel name to its branch group,
    ``pick_loop`` chooses the log-Euler loop among a kernel's loops,
    ``single_step(group)`` says whether a skipped region that is neither the
    Philox block nor a slow path runs once per path, and ``draws_per_step``
    (per group) lets a loop that calls Philox unskipped say how many steps
    it covers (``loop_weights``)."""
    counts, found = {}, {}
    for block in text.split("Function : ")[1:]:
        name = block.split()[0]
        group = next((g for key, g in kernels.items() if key in name), None)
        if group is None:
            continue
        weights, steps, found[group] = loop_weights(
            block, group, pick_loop=pick_loop, single_step=single_step,
            steps_per_iteration=steps_per_iteration.get(group, 1),
            draws_per_step=(draws_per_step or {}).get(group))
        counts[group] = sum(w for _, _, w in weights) / steps
    return counts, found


# The per-part split of a step loop's SASS: each instruction of the loop body
# (``loop_weights``, with its share of iterations) goes to the source lines it
# came from. The libraries are built with -lineinfo, and ``nvdisasm -gi`` names
# each instruction's line and the lines it was inlined at; of these, the ones
# in csrc/ files decide. Where one lies in a named stream helper the helper
# decides (SASS_HELPER_PARTS, in order: the Philox call and its key schedule;
# the Merton count with its uniform, and the jump; the uniforms and the
# Box–Muller transform; the word select); otherwise the lines' text, by the
# first pattern any of them matches (SASS_PART_TEXT: a monitor kernel's
# stores with their exp; the update; ...), else "branch" (loop control and
# the branch's own work).
SASS_HELPER_PARTS = (
    ({"philox4x32_10", "call"}, "philox"),
    ({"merton_count"}, "count"),
    ({"merton_jump"}, "jump"),
    ({"uniform_open", "uniform_closed", "box_muller_libm", "box_muller_sfu", "box_muller_sfu_cos",
      "box_muller_root", "box_muller_radius", "box_muller_angle", "minus_two_log", "lg2_sfu",
      "rsqrt_sfu", "sin_sfu", "cos_sfu", "box_muller_gbm", "gbm_normal", "ln_pinned",
      "sincos_2pi_pinned", "box_muller_pinned", "term_draw"}, "box_muller"),
    ({"draw", "triple"}, "philox"),
)
SASS_PART_TEXT = (
    ("stores", r"^\s*\*\w+ = "),
    ("update", r"\blogx(\[\w+\])? = |\bz_s\b|\bzm\b|\bmix\b|__fadd_rn\(logx|v_plus|\bsv\b"
               r"|\bv = |\binc\[\w+\] = |step_inc\[\w+\] = "),
    ("philox", r"philox|umulhi|kPhilox|\.call\("),
    ("box_muller", r"uniform_open|uniform_closed|logf\(u1\)|sincospif|\brad\b|box_muller"),
)
SASS_PARTS = ("philox", "box_muller", "count", "jump", "update", "stores", "branch")
# The same loop by the unit its instructions issue to (the ``mix`` of
# ``sass_split``): float32 (F*), integer (I*, LOP3, SHF, SEL, LEA, PRMT),
# the transcendental and conversion unit (MUFU, I2F, F2I, FRND) and the rest
# (moves, branches, the uniform datapath). An SM sub-partition issues one warp
# instruction a clock; its 32 float32 lanes take one a clock, its 16 integer
# lanes one every two and its 4 transcendental lanes one every eight.
SASS_UNITS = (("xu", r"^(MUFU|I2F|F2I|FRND|F2F|I2I)"),
              ("fp32", r"^(FFMA|FADD|FMUL|FMNMX|FSETP|FSEL|FCHK|FSWZADD)"),
              ("int", r"^(IMAD|IADD3|LOP3|SHF|SEL|ISETP|LEA|PRMT|IMNMX|IABS|IMUL|POPC|FLO|BMSK)"))


def parse_nvdisasm_lines(text: str) -> dict[str, dict[int, list[tuple[str, int]]]]:
    """``{mangled function: {address: [(file, line), ...]}}`` from the text
    of ``nvdisasm -gi``: the ``//## File`` lines before an instruction (an
    inlined line, then the line it was inlined at, one comment each), every
    frame they name."""
    out: dict[str, dict[int, list[tuple[str, int]]]] = {}
    fn, where, fresh = None, [], True
    for line in text.splitlines():
        head = re.match(r"\s*\.section\s+\.text\.([^,\s]+)", line) or re.match(
            r"\s*\.text\.(\S+?):\s*$", line)
        if head:
            fn, where, fresh = head.group(1), [], True
            out.setdefault(fn, {})
            continue
        loc = re.search(r'//## File "([^"]+)", line (\d+)(.*)', line)
        if loc:
            if fresh:
                where, fresh = [], False
            where = where + [(loc.group(1), int(loc.group(2)))] + [
                (f, int(n)) for f, n in re.findall(r'inlined at "([^"]+)", line (\d+)',
                                                   loc.group(3))]
            continue
        addr = re.search(r"/\*([0-9a-f]{4,})\*/", line)
        if addr and fn is not None:
            out[fn][int(addr.group(1), 16)] = where
            fresh = True
    return out


def enclosing_function(lines: list[str], index: int) -> str:
    """The name of the device function or kernel whose body holds line
    ``index`` (0-based) of a csrc/ file."""
    for text in reversed(lines[:index + 1]):
        sig = re.search(r"(?:__global__|__device__)[^(]*?\b(\w+)\s*\(", text)
        if sig:
            return sig.group(1)
    return ""


def part_of(frames: list[tuple[str, int]], read: object) -> str:
    """The part (SASS_PARTS) an instruction with these source frames
    belongs to."""
    names, texts = set(), []
    for file, line in frames:
        if "/csrc/" not in file:
            continue
        lines = read(file)
        names.add(enclosing_function(lines, line - 1))
        texts.append(lines[line - 1] if line <= len(lines) else "")
    for helpers, part in SASS_HELPER_PARTS:
        if names & helpers:
            return part
    return next((part for part, pattern in SASS_PART_TEXT
                 if any(re.search(pattern, text) for text in texts)), "branch")


def nvdisasm_text(library: object) -> str:
    """``nvdisasm -gi`` of every cubin in a built library."""
    import tempfile

    bindir = Path(find_nvcc()).parent
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(bindir / "cuobjdump"), "-xelf", "all", str(Path(library).resolve())],
                       cwd=tmp, capture_output=True, check=True)
        return "".join(
            subprocess.run([str(bindir / "nvdisasm"), "-gi", str(cubin)], capture_output=True,
                           text=True, check=True).stdout
            for cubin in sorted(Path(tmp).glob("*.cubin")))


def sass_split(sass: str, disasm: str, piece: str, *, draws_per_step: int,
               single_step: bool = False, pick_loop: object = None) -> dict[str, object]:
    """The per-path-step SASS of the step loop of the kernel whose mangled
    name holds ``piece`` (its longest loop, or ``pick_loop``'s), split into
    SASS_PARTS (the rule above), with the loop's derivation, its total and
    the FFMAs of the update part."""
    block = next(b for b in sass.split("Function : ")[1:] if piece in b.split()[0])
    name = block.split()[0]
    weights, steps, found = loop_weights(
        block, piece, pick_loop=pick_loop or (lambda loops: max(loops, key=len)),
        single_step=lambda group: single_step, draws_per_step=draws_per_step)
    frames = parse_nvdisasm_lines(disasm).get(name)
    if not frames:
        raise AssertionError(f"nvdisasm gave no line information for {name}")
    read = functools.lru_cache(None)(lambda f: Path(f).read_text().splitlines())
    split = dict.fromkeys(SASS_PARTS, 0.0)
    mix = dict.fromkeys([unit for unit, _ in SASS_UNITS] + ["other"], 0.0)
    update_ffma = 0.0
    for addr, op, w in weights:
        part = part_of(frames.get(addr, []), read)
        split[part] += w / steps
        mnemonic = re.sub(r"^@!?U?P\w+\s+", "", op)
        mix[next((u for u, pattern in SASS_UNITS if re.match(pattern, mnemonic)), "other")] += \
            w / steps
        if part == "update" and mnemonic.startswith("FFMA"):
            update_ffma += w / steps
    return {**{k: round(v, 3) for k, v in split.items()},
            "total": round(sum(split.values()), 3), "loop": found,
            "mix": {k: round(v, 3) for k, v in mix.items()}, "update_ffma": round(update_ffma, 3)}


# The cliquet kernel's SASS a path (``cliquet_sass_split``) at STEPS steps and
# CLIQUET's reset_every, by part (CLIQUET_PARTS): the index (path_setup: the
# thread's path, its counter and key), the coefficients (the contract's loads,
# dt, the period's drift and vol), the Philox call, the transform (the
# uniforms, the Box–Muller and the antithetic sign), the period's exp, clip
# and sum, the store, and the rest (loop control, exit). The step loop runs
# its ``loop_weights`` (the walk: one whole call, four periods, an
# iteration; the rolled loop of a v1 build: a draw, two periods, its Philox
# block every other iteration) over the periods of a path; every other
# instruction of the kernel's own code (up to its first subroutine or the
# parking branch) once, but the regions outside the loop that a branch
# skips and that hold a CALL (the slow paths) or a Philox call (the walk's
# tails, which a multiple of four periods never reaches; the tails' two
# guards of the odd count go with them).
CLIQUET_PARTS = ("index", "coefficients", "philox", "transform", "exp_clip", "store", "other")
CLIQUET_PART_TEXT = (
    ("store", r"\bout\[.*=\s*acc;"),
    ("exp_clip", r"\bexpf\(|exp_sfu|fminf|fmaxf|clipped"),
    ("transform", r"\brad\b|srad|sign \* rad|box_muller|uniform_open|uniform_closed|cospif"),
    ("coefficients", r"\bp\[|params|period_drift|period_vol|\bdt\b|reset_every|maturity|"
                     r"\brate\b|\bdiv\b"),
)


def cliquet_part(frames: list[tuple[str, int]], read: object) -> str:
    names, texts = set(), []
    for file, line in frames:
        if "/csrc/" not in file:
            continue
        lines = read(file)
        names.add(enclosing_function(lines, line - 1))
        texts.append(lines[line - 1] if line <= len(lines) else "")
    if "path_setup" in names:
        return "index"
    for helpers, part in SASS_HELPER_PARTS:
        if names & helpers and part in ("philox", "box_muller"):
            return "transform" if part == "box_muller" else part
    return next((part for part, pattern in CLIQUET_PART_TEXT
                 if any(re.search(pattern, text) for text in texts)), "other")


def cliquet_path_weights(block: str, steps: int = STEPS) -> tuple[
        list[tuple[int, str, float]], dict[str, object]]:
    """Each instruction of the cliquet kernel's own code (one function's
    ``cuobjdump -sass`` text) with the times a path of ``steps`` steps runs
    it (the rule above), and the derivation: the loop's, its iterations and
    the instructions counted outside it."""
    walked = any(walks(body) for body in block_loops(block))
    periods = steps // CLIQUET["reset_every"]
    if walked:
        weights, _, found = loop_weights(block, "cliquet", pick_loop=walk_loop,
                                         single_step=lambda group: False)
        iterations = periods // 4
    else:
        weights, _, found = loop_weights(block, "cliquet", pick_loop=last_loop_without_abs,
                                         single_step=lambda group: True)
        iterations = periods // 2
    in_loop = {a for a, _, _ in weights}
    ins = block_instructions(block)
    # the kernel's own code ends where its first subroutine (a CALL's
    # target) or the parking branch begins
    end = min([int(m.group(1), 16) for _, op in ins
               if (m := re.search(r"\bCALL\.\w+(?:\.\w+)* 0x([0-9a-f]+)", op))]
              + [a for a, op in ins if re.fullmatch(rf"BRA 0x0*{a:x}", op)]
              + [ins[-1][0] + 16])
    skipped = set()  # the slow paths and the walk's tails, outside the loop
    for addr, op in ins:
        jump = re.search(SASS_BRANCH, op)
        if not (jump and op.startswith("@") and addr < int(jump.group(1), 16) <= end):
            continue
        region = [(a, o) for a, o in ins if addr < a < int(jump.group(1), 16)]
        if in_loop & {a for a, _ in region}:
            continue
        if (any("CALL" in o for _, o in region)
                or sum(bool(re.search(PHILOX_MULTIPLY, o)) for _, o in region) >= 16):
            skipped.update(a for a, _ in region)
    outside = [(a, op, 1.0) for a, op in ins
               if a not in in_loop and a not in skipped and a < end]
    path = [(a, op, w * iterations) for a, op, w in weights] + outside
    return path, {"periods": periods, "iterations": iterations, "loop": found,
                  "outside_loop": len(outside)}


def cliquet_sass_split(sass: str, disasm: str, steps: int = STEPS) -> dict[str, object]:
    """The cliquet kernel's SASS a path, split into CLIQUET_PARTS (the rule
    above), with its total, the index's share and the derivation."""
    block = next(b for b in sass.split("Function : ")[1:]
                 if "gbm_cliquet_kernel" in b.split()[0])
    name = block.split()[0]
    weights, info = cliquet_path_weights(block, steps)
    frames = parse_nvdisasm_lines(disasm).get(name)
    if not frames:
        raise AssertionError(f"nvdisasm gave no line information for {name}")
    read = functools.lru_cache(None)(lambda f: Path(f).read_text().splitlines())
    split = dict.fromkeys(CLIQUET_PARTS, 0.0)
    for addr, _, w in weights:
        split[cliquet_part(frames.get(addr, []), read)] += w
    total = sum(split.values())
    return {**info, **{k: round(v, 3) for k, v in split.items()}, "total": round(total, 3),
            "per_path_step": round(total / steps, 3),
            "index_share": round(split["index"] / total, 4)}


# The fused QMC walk's SASS a point, split into words, normal, bridge and
# walk (``qmc_walk_sass``): the instructions after the block's table barrier
# (the per-point work; the tables cost a block once), each going to the part
# that its source lines' functions name, the inverse CDF's before the
# word's (QMC_PART_FUNCTIONS, in order), else "walk" (the walk, the stores,
# the addressing). An instruction inside a loop there (the dense walk's
# level loop) runs T times; one in erf⁻¹'s tail arm (w >= 5, behind a branch:
# a share ERFINV_TAIL of the normals) issues for a warp where any of its 32
# lanes takes it; a skipped region that stores without computing (the sparse
# walk's points on an edge of the range) never runs on the main path's
# ranges. A branch past more than half the body (an early return) is no
# region. Over the points a thread takes (the sparse walk's kQuad, the dense
# walk's 1).
QMC_WALK_PIECES = ("qmc_walk_sparse_kernelILi16E", "qmc_walk_kernelILi16E")
QMC_PART_FUNCTIONS = (({"word_normal", "erfinv_xla"}, "normal"),
                      ({"quad_words", "normal", "point_of"}, "words"),
                      ({"bridge_row", "bridge_factor"}, "bridge"))
QMC_PARTS = ("words", "normal", "bridge", "walk")
ERFINV_TAIL = 1.0 - math.sqrt(1.0 - math.exp(-5.0))  # P(|2u − 1| >= √(1 − e^-5))
ERFINV_TAIL_WARP = 1.0 - (1.0 - ERFINV_TAIL) ** 32


def qmc_part(frames: list[tuple[str, int]], read: object) -> tuple[str, bool]:
    """``(part, tail)``: the part (QMC_PARTS) of an instruction with these
    source frames, and whether it lies in erf⁻¹'s tail arm."""
    names, tail = set(), False
    for file, line in frames:
        if "/csrc/" not in file:
            continue
        lines = read(file)
        names.add(enclosing_function(lines, line - 1))
        text = lines[line - 1] if line <= len(lines) else ""
        tail = tail or bool(re.search(r"\bwl\b", text))
    part = next((part for fns, part in QMC_PART_FUNCTIONS if names & fns), "walk")
    return part, tail


def qmc_walk_sass(library: object, steps: int = STEPS,
                  source: Path = Path(__file__).resolve().parent / QMC_SOURCE,
                  ) -> dict[str, object]:
    """The fused walk's SASS a point at T = ``steps`` by part (the rule
    above), with the bridge part's FFMAs, in the library's sparse walk where
    it has one, else its dense walk; ``source`` is the library's
    ``qmc_paths.cu`` (its ``kQuad``)."""
    sass = cuobjdump_sass(library)
    blocks = {b.split()[0]: b for b in sass.split("Function : ")[1:]}
    piece = next(piece for piece in QMC_WALK_PIECES if any(piece in name for name in blocks))
    name = next(name for name in blocks if piece in name)
    quad = re.search(r"constexpr int kQuad = (\d+);", source.read_text())
    points = int(quad.group(1)) if piece == QMC_WALK_PIECES[0] else 1
    ins = [(int(a, 16), op.strip()) for a, op in re.findall(SASS_LINE, blocks[name])]
    bar = max(i for i, (_, op) in enumerate(ins) if op.startswith("BAR"))
    body = [(a, op) for a, op in ins[bar + 1:] if not op.startswith("NOP")]
    in_loop, regions = set(), []
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        if not jump:
            continue
        target = int(jump.group(1), 16)
        if body[0][0] <= target < addr and sum(target <= a <= addr for a, _ in body) > 1:
            in_loop.update(a for a, _ in body if target <= a <= addr)
        elif op.startswith("@") and target > addr:
            region = [a for a, _ in body if addr < a < target]
            if len(region) < len(body) // 2:  # not the early return's jump past all
                regions.append(set(region))
    ops_of = dict(body)
    edge = {a for r in regions for a in r
            if any(re.search(r"\bSTG\.E\b", ops_of[b]) for b in r)
            and not any(ops_of[b].startswith("FFMA") for b in r)}
    skipped = {a for r in regions for a in r}
    frames = parse_nvdisasm_lines(nvdisasm_text(library)).get(name)
    if not frames:
        raise AssertionError(f"nvdisasm gave no line information for {name}")
    read = functools.lru_cache(None)(lambda f: Path(f).read_text().splitlines())
    split, bridge_ffma = dict.fromkeys(QMC_PARTS, 0.0), 0.0
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        if jump and int(jump.group(1), 16) == addr:  # the parking branch after EXIT
            continue
        part, tail = qmc_part(frames.get(addr, []), read)
        w = (steps if addr in in_loop else 1) / points
        if addr in edge:
            w = 0.0
        elif tail and addr in skipped:
            w *= ERFINV_TAIL_WARP
        split[part] += w
        if part == "bridge" and re.sub(r"^@!?U?P\w+\s+", "", op).startswith("FFMA"):
            bridge_ffma += w
    return {"instantiation": piece, "points_per_thread": points,
            **{k: round(v, 3) for k, v in split.items()},
            "total": round(sum(split.values()), 3), "bridge_ffma": round(bridge_ffma, 3),
            "tail_warp_share": round(ERFINV_TAIL_WARP, 4)}


# Kernel #13's SASS a point and factor at T = 16, F = 1 with no padded
# dimension (``qmc_bridge_sass``), split into words, normal, bridge, stores
# and other (addressing, the factor loop): the instructions after the
# block's table barrier, each going to a part by its source lines — the
# checks' word copy (``copy_words``; the dense kernel's ``words_out`` block)
# and the padded reads (``pad_normals``; the dense kernel's ``pad[``) never
# run on the main path, and neither do the one-float stores of a pair on the
# range's edges (``store_row``'s lines but its vector store), nor the
# sparse kernel's copy of a factor's rows for padded dimensions (the
# shortest forward-branch region holding every padded read) — then by the
# functions they name (QMC_BRIDGE_PART_FUNCTIONS, in order), else "other".
# The dense kernel's level loop (the shortest loop holding the bridge's
# FFMAs) runs T times; erf⁻¹'s tail arm counts as in the walk; over the
# points a thread takes (the sparse kernel's kQuad, the dense kernel's 1).
QMC_BRIDGE_PIECES = ("qmc_bridge_sparse_kernelILi16E", "qmc_bridge_kernelILi16E")
QMC_BRIDGE_IDLE_TEXT = r"words_out|tab\.c_hi\[k\]|w \^= pt\.mask|if \(in\[i\]\) o\["
QMC_BRIDGE_PART_FUNCTIONS = (({"pad_normals"}, "pad"), ({"copy_words"}, "idle"),
                             ({"word_normal", "erfinv_xla"}, "normal"),
                             ({"quad_words", "quad_mask", "normal", "point_of"}, "words"),
                             ({"bridge_row", "bridge_factor"}, "bridge"),
                             ({"store_row"}, "stores"))
QMC_BRIDGE_PARTS = ("words", "normal", "bridge", "stores", "other")


def qmc_bridge_part(frames: list[tuple[str, int]], read: object) -> tuple[str, bool]:
    """``(part, tail)`` of an instruction of kernel #13 (the rule above;
    "idle" for what the main path never runs)."""
    names, texts, tail = set(), [], False
    for file, line in frames:
        if "/csrc/" not in file:
            continue
        lines = read(file)
        names.add(enclosing_function(lines, line - 1))
        texts.append(lines[line - 1] if line <= len(lines) else "")
        tail = tail or bool(re.search(r"\bwl\b", texts[-1]))
    if any(re.search(r"\bpad\[", text) for text in texts):
        return "pad", tail
    if any(re.search(QMC_BRIDGE_IDLE_TEXT, text) for text in texts):
        return "idle", tail
    if any(re.search(r"\bout_c\[", text) for text in texts):
        return "stores", tail
    return next((part for fns, part in QMC_BRIDGE_PART_FUNCTIONS if names & fns), "other"), tail


def qmc_bridge_sass(library: object, steps: int = STEPS,
                    source: Path = Path(__file__).resolve().parent / QMC_SOURCE,
                    ) -> dict[str, object]:
    """Kernel #13's SASS a point and factor at T = ``steps`` by part (the
    rule above), with the bridge part's FFMAs, in the library's sparse
    bridge where it has one, else its dense bridge."""
    sass = cuobjdump_sass(library)
    blocks = {b.split()[0]: b for b in sass.split("Function : ")[1:]}
    piece = next(piece for piece in QMC_BRIDGE_PIECES if any(piece in name for name in blocks))
    name = next(name for name in blocks if piece in name)
    sparse = piece == QMC_BRIDGE_PIECES[0]
    quad = re.search(r"constexpr int kQuad = (\d+);", source.read_text())
    points = int(quad.group(1)) if sparse else 1
    ins = [(int(a, 16), op.strip()) for a, op in re.findall(SASS_LINE, blocks[name])]
    bar = max(i for i, (_, op) in enumerate(ins) if op.startswith("BAR"))
    body = [(a, op) for a, op in ins[bar + 1:] if not op.startswith("NOP")]
    frames = parse_nvdisasm_lines(nvdisasm_text(library)).get(name)
    if not frames:
        raise AssertionError(f"nvdisasm gave no line information for {name}")
    read = functools.lru_cache(None)(lambda f: Path(f).read_text().splitlines())
    parts = {a: qmc_bridge_part(frames.get(a, []), read) for a, _ in body}
    loops, skipped, forward = [], set(), []
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        if not jump:
            continue
        target = int(jump.group(1), 16)
        if body[0][0] <= target < addr:
            loops.append({a for a, _ in body if target <= a <= addr})
        elif target > addr:
            region = {a for a, _ in body if addr < a < target}
            forward.append(region)
            if op.startswith("@") and len(region) < len(body) // 2:  # not the early return
                skipped |= region
    padded = {a for a, (part, _) in parts.items() if part == "pad"}
    if padded and sparse:  # the sparse kernel's rows around its padded reads
        for a in min((r for r in forward if padded <= r), key=len, default=padded):
            parts[a] = ("idle", parts[a][1])
    ffma = {a for a, op in body
            if parts[a][0] == "bridge" and re.sub(r"^@!?U?P\w+\s+", "", op).startswith("FFMA")}
    level = set() if sparse else min((lp for lp in loops if lp & ffma), key=len, default=set())
    split, bridge_ffma = dict.fromkeys(QMC_BRIDGE_PARTS, 0.0), 0.0
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        part, tail = parts[addr]
        if part in ("idle", "pad") or (jump and int(jump.group(1), 16) == addr):
            continue  # never on the main path, or the parking branch after EXIT
        w = (steps if addr in level else 1) / points
        if tail and addr in skipped:
            w *= ERFINV_TAIL_WARP
        split[part] += w
        if addr in ffma:
            bridge_ffma += w
    return {"instantiation": piece, "points_per_thread": points,
            **{k: round(v, 3) for k, v in split.items()},
            "total": round(sum(split.values()), 3), "bridge_ffma": round(bridge_ffma, 3),
            "tail_warp_share": round(ERFINV_TAIL_WARP, 4)}


# --------------------------------------------------------------------------
# 2. kernel vs twin
# --------------------------------------------------------------------------


def kernel_inputs(
    device: torch.device, contracts: int, seed: int, family: str = "gbm"
) -> tuple[torch.Tensor, ...]:
    """Seeded contracts inside the family's bounds and their stream keys."""
    gen = np.random.default_rng(seed)
    bounds = FAMILY_BOUNDS[family]
    lo = np.array([b.lower for b in bounds.values()])
    hi = np.array([b.upper for b in bounds.values()])
    params = (lo + (hi - lo) * gen.random((contracts, len(lo)))).astype(np.float32)
    keys = rng.fold_in(rng.prng_key(7), torch.arange(contracts, dtype=torch.int64))
    return torch.from_numpy(params).to(device), keys.to(device)


FAMILY_FNS = {
    "term": (dynamics_cuda.simulate_term_rows_cuda, dynamics_cuda.simulate_term_rows_cuda_plain),
    "heston": (dynamics_cuda.simulate_heston_rows_cuda,
               dynamics_cuda.simulate_heston_rows_cuda_plain),
    "merton": (dynamics_cuda.simulate_merton_rows_cuda,
               dynamics_cuda.simulate_merton_rows_cuda_plain),
    "basket": (basket_cuda.simulate_basket_rows_cuda,
               basket_cuda.simulate_basket_rows_cuda_plain),
}


def kernel_and_twin(family: str, payoff: PayoffKind, kw: dict[str, object]) -> tuple:
    """``(kernel, twin)``, each ``(params, keys) -> values`` for one case."""
    if family == "gbm" and payoff == PayoffKind.CLIQUET:
        fns = (gbm_cuda.simulate_cliquet_rows_cuda, gbm_cuda.simulate_cliquet_rows_cuda_plain)
    elif family == "gbm":
        fns = (gbm_cuda.simulate_underlier_rows_cuda, gbm_cuda.simulate_underlier_rows_cuda_plain)
        kw = dict(kw, payoff=payoff)
    else:
        fns = FAMILY_FNS[family]
        kw = dict(kw, payoff=payoff)
        if family == "term":
            kw["term"] = term_of(int(kw["timesteps"]))
    return tuple(functools.partial(fn, **kw) for fn in fns)


def compare(
    device: torch.device, payoff: PayoffKind, contracts: int = 4, family: str = "gbm",
    **kw: object,
) -> dict[str, float]:
    """The kernel against its twin over ``contracts`` contracts; raises past
    the tolerances. Returns ``max_abs_err`` and ``max_rel`` over the agreeing
    paths, ``flips`` (the paths past ``KERNEL_RTOL``), ``plain_ms`` (the
    twin's one call by CUDA events: it takes seconds at the timed shapes, so
    a warm-up call would double its cost for milliseconds of set-up) and,
    for a continuous Heston payoff, ``past_rel`` (the largest scaled error
    among the paths past the tolerance) with ``past_low`` and ``all_low`` (how
    many of those paths, and what share of all paths, had a low variance).
    A Merton kernel's final log-price must equal its twin's bit for bit on
    every path (``log_unequal``, 0)."""
    params, keys = kernel_inputs(device, contracts, contracts + int(kw["timesteps"]), family)
    kernel, twin = kernel_and_twin(family, payoff, kw)
    traces = ({}, {}) if family == "merton" else None
    got = kernel(params, keys) if traces is None else kernel(params, keys, trace=traces[0])
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = twin(params, keys) if traces is None else twin(params, keys, trace=traces[1])
    stop.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{family}/{payoff.value}: kernel produced non-finite values at {kw}")
    exact = (family == "term" or payoff == PayoffKind.CLIQUET)
    unequal = int((got != want).sum()) if exact or family == "heston" else None
    if exact and unequal:
        raise AssertionError(f"{family}/{payoff.value}: the kernel's value is not the twin's "
                             f"on {unequal} paths at {kw}")
    log_unequal = None
    if traces is not None:
        log_unequal = int((traces[0]["log_price"] != traces[1]["log_price"]).sum())
        if log_unequal:
            raise AssertionError(f"merton/{payoff.value}: the kernel's log-price is not the "
                                 f"twin's on {log_unequal} paths at {kw}")
        del traces
    scale = want.abs()
    if payoff in LOOKBACK_PAYOFFS:
        scale = torch.maximum(scale, params[:, 1, None, None])
    if payoff == PayoffKind.CLIQUET:
        scale = torch.clamp(scale, min=float(kw["cap"]))
    err = (got - want).abs()
    ok = err <= KERNEL_RTOL * scale
    flips = int((~ok).sum())
    jumps = payoff in BARRIER_PAYOFFS or payoff == PayoffKind.DIGITAL
    share = (FLIP_SHARE if jumps else 0.0) + (HESTON_SHARE if family == "heston" else 0.0)
    allowed = int(share * got.numel())
    if flips > allowed:
        raise AssertionError(f"{family}/{payoff.value}: {flips} paths past rtol {KERNEL_RTOL} "
                             f"(allowed {allowed}) at {kw}")
    agree = torch.where(ok, err, torch.zeros_like(err))
    found = dict(max_abs_err=float(agree.max()), max_rel=float((agree / scale).max()),
                 flips=flips, plain_ms=start.elapsed_time(stop))
    if log_unequal is not None:
        found["log_unequal"] = log_unequal
    if unequal is not None:
        found["unequal"] = unequal
    if family == "heston" and not jumps and flips:
        found["past_rel"] = float((err / scale)[~ok].max())
        if found["past_rel"] > HESTON_CAP_RTOL:
            raise AssertionError(f"heston/{payoff.value}: a path past rtol {KERNEL_RTOL} misses "
                                 f"by {found['past_rel']:.3e} (cap {HESTON_CAP_RTOL}) at {kw}")
        del got, want, err, agree, scale
        trace: dict[str, torch.Tensor] = {}
        twin(params, keys, trace=trace)
        low = trace["min_variance"] < HESTON_LOW_VARIANCE
        found.update(past_low=int(low[~ok].sum()), all_low=float(low.float().mean()))
    return found


def kernel_cases() -> list[tuple[str, str, PayoffKind, dict[str, object]]]:
    """(group, family, payoff, kwargs) for every case of phase 2."""
    base = dict(rows=ROWS, cols=COLS)
    cases = []
    for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
        for half in (None, ROWS // 2):
            anti = dict(base, scheme=scheme, antithetic_half=half)
            odd = (STEPS, 15) if scheme == PathScheme.LOG_EULER and half is None else (STEPS,)
            for steps in odd:
                cases.append(("terminal", PayoffKind.TERMINAL, dict(anti, timesteps=steps)))
                cases.append(("variance", PayoffKind.VARIANCE_SWAP, dict(anti, timesteps=steps)))
            cases.append(("terminal", PayoffKind.DIGITAL, dict(anti, timesteps=STEPS)))
            cases.append(("terminal", PayoffKind.FORWARD_START,
                          dict(anti, timesteps=STEPS, forward_start_step=FORWARD_STEP)))
            for payoff in (PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT):
                cases.append(("barrier", payoff,
                              dict(anti, timesteps=STEPS, barrier_rel=KNOBS[payoff]["barrier_rel"])))
            for payoff in sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value):
                cases.append(("lookback", payoff, dict(anti, timesteps=STEPS)))
            for payoff in (PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC):
                cases.append(("asian", payoff, dict(anti, timesteps=STEPS)))
    for half in (None, ROWS // 2):
        # 2, 3, 4 and 5 periods: the walk's half call, its single tail in the
        # same call, one whole call, and a tail in a second call
        for steps in CLIQUET_STEPS:
            cases.append(("cliquet", PayoffKind.CLIQUET,
                          dict(base, timesteps=steps, antithetic_half=half, **CLIQUET)))
    cases = [(group, "gbm", payoff, kw) for group, payoff, kw in cases]
    payoffs = [PayoffKind.TERMINAL, PayoffKind.DIGITAL, PayoffKind.FORWARD_START,
               PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT,
               *sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value), PayoffKind.VARIANCE_SWAP,
               PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC]
    for family in FAMILIES:
        for half in (None, ROWS // 2):
            for payoff in payoffs:
                # the Merton walk's tails of 3 and 1 steps (four steps a pass);
                # the term walks' tails (a single step after the pairs, or
                # after a one-draw branch's pairs of steps) in both modes
                tails = family == "merton" and payoff == PayoffKind.TERMINAL
                odd = (STEPS, 15, 13) if tails else (STEPS,)
                for steps in ((STEPS, 15) if family == "term" else
                              odd if half is None else (STEPS,)):
                    kw = dict(base, timesteps=steps, antithetic_half=half)
                    if payoff in BARRIER_PAYOFFS:
                        kw["barrier_rel"] = KNOBS[payoff]["barrier_rel"]
                    if payoff == PayoffKind.FORWARD_START:
                        kw["forward_start_step"] = FORWARD_STEP
                    cases.append((group_of(family, branch_of(family, payoff)), family, payoff, kw))
    return cases


# the payoff each branch group is timed with at the training chunk
TIMED_PAYOFF = {
    "terminal": (PayoffKind.TERMINAL, {}),
    "barrier": (PayoffKind.BARRIER_UP_OUT, dict(barrier_rel=1.25)),
    "lookback": (PayoffKind.LOOKBACK_FIXED_CALL, {}),
    "variance": (PayoffKind.VARIANCE_SWAP, {}),
    "asian": (PayoffKind.ASIAN_ARITHMETIC, {}),
    "cliquet": (PayoffKind.CLIQUET, CLIQUET),
    "forward": (PayoffKind.FORWARD_START, dict(forward_start_step=FORWARD_STEP)),
}
# group -> (family, timed payoff, its knobs), in gbm_cuda.BRANCHES' order; the
# basket, QMC and American kernels have phases of their own
TIMED = {
    group: (group.rpartition("_")[0] or "gbm", *TIMED_PAYOFF[group.rpartition("_")[2]])
    for group in gbm_cuda.BRANCHES
    if not group.startswith(("basket_", "qmc_", "american_", "lsmc_", "torch_"))
}


# The kernels whose main path is the batch-64 correctness steps of phases 8,
# 10, 16 and 26 only (PERF.md §6): each is timed at that batch besides.
LAUNCHED_AT_STEP_BATCH = ("term_", "merton_", "cliquet")


def check_merton_counts(device: torch.device) -> int:
    """The Merton kernel's jump counts against its twin's, exactly: with the
    Gaussians switched off (vol = jump_std = 0) and unit jumps,
    ``ln S_T − T·drift`` is the path's total count. Returns the jumps seen."""
    c = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 2.5, 1.0, 0.0],
                      [1.0, 1.0, 2.0, 0.0, 0.0, 0.0, 6.0, 1.0, 0.0]], device=device)
    keys = rng.fold_in(rng.prng_key(4), torch.arange(2)).to(device)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, payoff=PayoffKind.TERMINAL,
              antithetic_half=ROWS // 2)
    drift = -c[:, 6] * (math.e - 1.0) * c[:, 2]  # the compensator over the whole path
    kernel, twin = (torch.round(torch.log(fn(c, keys, **kw)) - drift[:, None, None])
                    for fn in FAMILY_FNS["merton"])
    if not torch.equal(kernel, twin):
        raise AssertionError(f"Merton counts differ on {int((kernel != twin).sum())} paths")
    if not torch.equal(kernel[:, :ROWS // 2], kernel[:, ROWS // 2:]):
        raise AssertionError("an antithetic pair does not share its Merton counts")
    return int(kernel.sum())


def phase_kernel(
    device: torch.device, per_step: dict[str, float], max_sm_hz: float
) -> dict[str, dict[str, object]]:
    record = {g: {"max_abs_err": 0.0, "max_rel": 0.0, "flips": 0, "cases": 0} for g in TIMED}
    past = {"paths": 0, "max_rel": 0.0, "low_variance": 0, "low_share_of_all_paths": 0.0}

    def fold(group: str, found: dict[str, float]) -> None:
        r = record[group]
        r.update(max_abs_err=max(r["max_abs_err"], found["max_abs_err"]),
                 max_rel=max(r["max_rel"], found["max_rel"]),
                 flips=r["flips"] + found["flips"], cases=r["cases"] + 1)
        if "unequal" in found:  # paths whose value is not the twin's bit for bit (Heston;
            # the term kernel and the cliquet: 0)
            r["not_bit_equal"] = r.get("not_bit_equal", 0) + found["unequal"]
        if "log_unequal" in found:  # Merton: paths whose log-price is not the twin's (0)
            r["log_not_bit_equal"] = r.get("log_not_bit_equal", 0) + found["log_unequal"]
        if "past_rel" in found:
            past.update(paths=past["paths"] + found["flips"],
                        max_rel=max(past["max_rel"], found["past_rel"]),
                        low_variance=past["low_variance"] + found["past_low"],
                        low_share_of_all_paths=max(past["low_share_of_all_paths"],
                                                   found["all_low"]))

    for group, family, payoff, kw in kernel_cases():
        fold(group, compare(device, payoff, family=family, **kw))
    phase("kernel-counts", merton_jumps_equal_to_the_twins=check_merton_counts(device),
          paths=2 * ROWS * COLS, steps=STEPS)
    for group, (family, payoff, extra) in TIMED.items():
        kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, **extra)
        launched = {}
        if family == "gbm" and payoff != PayoffKind.CLIQUET:
            kw["scheme"] = PathScheme.LOG_EULER
        # the timed shape, checked; the twin's call there is its time
        found = compare(device, payoff, CHUNK, family, **kw)
        fold(group, found)
        r, plain_ms = record[group], found["plain_ms"]
        params, keys = kernel_inputs(device, CHUNK, 1, family)
        kernel, _ = kernel_and_twin(family, payoff, kw)
        ms = cuda_ms(lambda: kernel(params, keys))
        if group.startswith(LAUNCHED_AT_STEP_BATCH):  # its main path's shape too
            small, small_keys = kernel_inputs(device, PAYOFF_BATCH, 1, family)
            launched = dict(launched_shape=f"{PAYOFF_BATCH}x{ROWS}x{COLS}x{STEPS}",
                            launched_ms=f"{cuda_ms(lambda: kernel(small, small_keys)):.3f}",
                            launched_bound_ms=f"{bound_ms(group, PAYOFF_BATCH, STEPS)[0]:.3f}")
        bound, bound_by = bound_ms(group, CHUNK, STEPS)
        path_steps = CHUNK * ROWS * COLS * STEPS
        cap = LANES_PER_CLOCK * max_sm_hz / per_step[group]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        phase("kernel", branch=group, cases=r["cases"], max_rel_diff=f"{r['max_rel']:.3e}",
              max_abs_err=f"{r['max_abs_err']:.3e}", flips=r["flips"], rtol=KERNEL_RTOL,
              **({"paths_not_bit_equal": r["not_bit_equal"]} if "not_bit_equal" in r else {}),
              **({"log_price_paths_not_bit_equal": r["log_not_bit_equal"]}
                 if "log_not_bit_equal" in r else {}),
              shape=f"{CHUNK}x{ROWS}x{COLS}x{STEPS}", timed=payoff.value,
              kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.3f}",
              bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
              kernel_path_steps_per_s=f"{path_steps / ms * 1e3:.4e}",
              plain_path_steps_per_s=f"{path_steps / plain_ms * 1e3:.4e}",
              instruction_cap_path_steps_per_s=f"{cap:.4e}",
              **cap_share(path_steps / ms * 1e3, cap), **launched)
    # the continuous Heston payoffs' paths past KERNEL_RTOL, and their cause
    phase("kernel-heston-past-rtol", **past, max_rel_cap=HESTON_CAP_RTOL,
          share_allowed=HESTON_SHARE, low_variance_below=HESTON_LOW_VARIANCE)
    return record


# --------------------------------------------------------------------------
# 3. oracles
# --------------------------------------------------------------------------

ORACLE_CONTRACTS = [
    [100.0, 100.0, 1.0, 0.03, 0.01, 0.25],  # ATM
    [100.0, 110.0, 1.0, 0.03, 0.01, 0.25],  # ITM put
    [100.0, 90.0, 1.0, 0.03, 0.01, 0.25],   # OTM put
]
STRIKES = {
    PayoffKind.VARIANCE_SWAP: (0.0625, 0.05, 0.08),  # vol² units; fair ≈ 0.0626
    PayoffKind.CLIQUET: (0.03, 0.0, 0.06),  # return units
}


# The lattice oracles (barrier, lookback, cliquet) carry a discretization
# error of their own. It is estimated as the change when the lattice is
# coarsened by half and added to the MC standard error in quadrature. The
# barrier's knock mask on a log grid converges at first order in the spacing
# (the up-and-out call at 2,049 points sits 4.7 SE of 1,048,576 paths above
# its limit), so the gate runs it at 8,193 points.
BARRIER_GRID = 8193


@functools.lru_cache(maxsize=None)
def lookback_prices(c: tuple[float, ...], coarse: bool = False) -> analytic.LookbackPrices:
    """All four lookbacks of a contract from one survival integration."""
    grid = dict(grid_points=769, levels=513) if coarse else {}
    return analytic.lookback_price(*c, timesteps=STEPS, **grid)


@functools.lru_cache(maxsize=None)
def oracle_prices(payoff: PayoffKind, c: tuple[float, ...]) -> tuple[tuple[float, float], ...]:
    """``((put, put_err), (call, call_err))`` of the port's oracle, each
    price NaN where the channel has none; the error is 0 for closed forms."""
    s, k, t, r, q, v = c
    nan = (math.nan, 0.0)
    if payoff == PayoffKind.TERMINAL:
        p = analytic.black_scholes_price(*c)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.ASIAN_GEOMETRIC:
        p = analytic.geometric_asian_price(*c, timesteps=STEPS)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.DIGITAL:
        put, call = analytic.digital_price(*c)
        return (float(put), 0.0), (float(call), 0.0)
    if payoff == PayoffKind.FORWARD_START:
        p = analytic.forward_start_price(*c, timesteps=STEPS, start_step=6)
        return (float(p.put), 0.0), (float(p.call), 0.0)
    if payoff == PayoffKind.VARIANCE_SWAP:
        p = analytic.variance_option_price(k, t, r, q, v, timesteps=STEPS)
        return (p.put, 0.0), (p.call, 0.0)
    if payoff in LOOKBACK_PAYOFFS:
        field = payoff.value.removeprefix("lookback_")
        fine = getattr(lookback_prices(c), field)
        return (fine, abs(fine - getattr(lookback_prices(c, coarse=True), field))), nan
    if payoff in BARRIER_PAYOFFS:
        fine, coarse = (
            analytic.discrete_barrier_price(*c, timesteps=STEPS, grid_points=g,
                                            up=payoff == PayoffKind.BARRIER_UP_OUT,
                                            **KNOBS[payoff])
            for g in (BARRIER_GRID, BARRIER_GRID // 2 + 1)
        )
    else:
        assert payoff == PayoffKind.CLIQUET
        fine, coarse = (
            analytic.cliquet_price(*c, timesteps=STEPS, local_floor=CLIQUET["floor"],
                                   local_cap=CLIQUET["cap"], reset_every=CLIQUET["reset_every"],
                                   grid=g)
            for g in (1 << 16, 1 << 15)
        )
    return ((fine.put, abs(fine.put - coarse.put)), (fine.call, abs(fine.call - coarse.call)))


def z_score(mean: float, se: float, want: float, err: float) -> float:
    """|MC − oracle| over the MC standard error and the oracle's own error."""
    scale = math.hypot(se, err)
    if scale == 0.0:
        return 0.0 if abs(mean - want) < 1e-6 else math.inf
    return abs(mean - want) / scale


def phase_oracle(device: torch.device) -> None:
    kinds = [PayoffKind.TERMINAL, PayoffKind.ASIAN_GEOMETRIC, *sorted(BARRIER_PAYOFFS, key=str),
             *sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value), PayoffKind.VARIANCE_SWAP,
             PayoffKind.DIGITAL, PayoffKind.FORWARD_START, PayoffKind.CLIQUET,
             PayoffKind.ASIAN_ARITHMETIC]
    for payoff in kinds:
        sim = build_simulation_params(
            timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=3,
            implementation="cuda", normalization="none", payoff=payoff.value,
            **KNOBS.get(payoff, {}),
        ).expect("oracle sim")
        rows_of = make_underlier_simulator(sim, rows=ROWS)
        base = [list(c) for c in ORACLE_CONTRACTS]
        for i, strike in enumerate(STRIKES.get(payoff, ())):
            base[i][1] = strike
        contracts = torch.tensor(base, dtype=torch.float32, device=device)
        keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), torch.arange(3, device=device))
        u = rows_of(keys, contracts).reshape(3, -1)
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{payoff.value}: non-finite underliers")
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            mean = u.double().mean(dim=1).cpu().numpy()
            se = (u.double().std(dim=1) / math.sqrt(u.shape[1])).cpu().numpy()
            want = expected_underlier_mean(contracts.double().cpu(), timesteps=STEPS,
                                           payoff=payoff, dtype=torch.float64).numpy()
            z = np.abs(mean - want) / se
            if not np.all(z < 4.0):
                raise AssertionError(f"asian_arithmetic mean {mean} vs {want}: z={z}")
            phase("oracle", payoff=payoff.value, paths=u.shape[1], mc_mean=np.round(mean, 5).tolist(),
                  expected=np.round(want, 5).tolist(), z=np.round(z, 3).tolist())
            continue
        prices = terminal_to_prices(u, contracts, normalize=False, dtype=torch.float32)
        found = {}
        for side, pay in (("put", prices.put_payoffs), ("call", prices.call_payoffs)):
            pay = pay.double()
            mean = pay.mean(dim=1).cpu().numpy()
            se = (pay.std(dim=1) / math.sqrt(pay.shape[1])).cpu().numpy()
            for i, c in enumerate(base):
                want, err = oracle_prices(payoff, tuple(c))[0 if side == "put" else 1]
                if math.isnan(want):
                    continue
                z = z_score(float(mean[i]), float(se[i]), want, err)
                if not z < 4.0:
                    raise AssertionError(f"{payoff.value} {side} contract {i}: MC {mean[i]:.6f} "
                                         f"± {se[i]:.2e} vs oracle {want:.6f} ± {err:.1e} "
                                         f"(z={z:.2f})")
                found.setdefault(side, []).append(
                    (round(float(mean[i]), 5), round(float(se[i]), 5), round(want, 5),
                     float(f"{err:.2g}"), round(z, 3)))
        phase("oracle", payoff=payoff.value, paths=u.shape[1],
              **{f"{side}_mc_se_oracle_err_z": repr(v) for side, v in found.items()})


# The families' oracle contracts: the GBM three under the curves of
# ``term_of``; Heston at the centre of its bounds (2·kappa·theta >= xi²) and
# Merton at the JAX bench's contract (bench.py:1041-1044), each at three strikes.
FAMILY_ORACLE_CONTRACTS = {
    "term": ORACLE_CONTRACTS,
    "heston": [[100.0, k, 1.0, 0.03, 0.01, 0.04, 1.5, 0.04, 0.3, -0.7]
               for k in (100.0, 110.0, 90.0)],
    "merton": [[100.0, k, 1.0, 0.03, 0.01, 0.2, 0.5, -0.1, 0.25] for k in (100.0, 110.0, 90.0)],
}
HESTON_ORACLE_STEPS = 32  # the Euler scheme's bias must stay under the standard error


def family_oracle(family: str, c: list[float], steps: int) -> tuple[float, float]:
    """``(put, call)`` of the family's European oracle for one contract."""
    if family == "term":
        vs, rs, qs = term_of(steps).shapes(steps)
        p = analytic.term_effective_black(*c, vol_shape=vs, rate_shape=rs, div_shape=qs)
        return float(p.put), float(p.call)
    price = heston_call_price if family == "heston" else merton_call_price
    call, put = price(**dict(zip(FAMILY_CONTRACT[family].model_fields, c)))
    return put, call


def phase_oracle_families(device: torch.device) -> None:
    """Curved GBM, Heston and Merton TERMINAL prices on the "cuda" engine
    against their European oracles, and the sample mean of S_T against the
    forward, each within 4 standard errors at 1,048,576 paths. Heston is
    gated at 32 steps; its 16-step scores are printed ungated (past 4 they
    would be the scheme's bias, not the kernel's)."""
    for family in FAMILIES:
        for steps in ((STEPS, HESTON_ORACLE_STEPS) if family == "heston" else (STEPS,)):
            gated = family != "heston" or steps == HESTON_ORACLE_STEPS
            curves = {"term": term_of(steps)} if family == "term" else {}
            sim = build_simulation_params(
                timesteps=steps, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=3,
                implementation="cuda", normalization="none", model=FAMILY_MODEL[family], **curves,
            ).expect("oracle sim")
            rows_of = make_underlier_simulator(sim, rows=ROWS)
            base = FAMILY_ORACLE_CONTRACTS[family]
            contracts = torch.tensor(base, dtype=torch.float32, device=device)
            keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), torch.arange(3, device=device))
            group = group_of(family, "terminal")
            before = gbm_cuda.LAUNCHES_BY_BRANCH[group]
            u = rows_of(keys, contracts).reshape(3, -1)
            if gbm_cuda.LAUNCHES_BY_BRANCH[group] != before + 1:
                raise AssertionError(f"{family}: the oracle run did not launch {group}")
            if not bool(torch.isfinite(u).all()):
                raise AssertionError(f"{family}: non-finite terminal values")
            prices = terminal_to_prices(u, contracts, normalize=False, dtype=torch.float32,
                                        term=sim.term)
            found = {}
            samples = (("put", prices.put_payoffs), ("call", prices.call_payoffs), ("mean", u))
            for side, pay in samples:
                pay = pay.double()
                mean = pay.mean(dim=1).cpu().numpy()
                se = (pay.std(dim=1) / math.sqrt(pay.shape[1])).cpu().numpy()
                for i, c in enumerate(base):
                    if side == "mean":  # the martingale: E[S_T] = S·e^{(r−q)T} at the curves' means
                        want = float(prices.forward[i])
                    else:
                        want = family_oracle(family, c, steps)[0 if side == "put" else 1]
                    z = z_score(float(mean[i]), float(se[i]), want, 0.0)
                    if gated and not z < 4.0:
                        raise AssertionError(f"{family} {side} contract {i} at {steps} steps: MC "
                                             f"{mean[i]:.6f} ± {se[i]:.2e} vs {want:.6f} (z={z:.2f})")
                    found.setdefault(side, []).append(
                        (round(float(mean[i]), 5), round(float(se[i]), 5), round(want, 5),
                         round(z, 3)))
            phase("oracle", family=family, payoff="terminal", steps=steps, paths=u.shape[1],
                  gated=gated, **{f"{side}_mc_se_oracle_z": repr(v) for side, v in found.items()})


# --------------------------------------------------------------------------
# 4-10. the trainer: train, resume, serve
# --------------------------------------------------------------------------


def production_cvnn():
    return build_cvnn_config(
        layers=[
            LinearCfg(width=256, activation=Activation.MODRELU),
            CovBNCfg(),
            ResidualCfg(
                body=SequentialCfg(layers=(
                    LinearCfg(width=256, activation=Activation.ZRELU),
                    LinearCfg(width=256, activation=Activation.NONE),
                )),
                activation=Activation.MODRELU,
            ),
        ],
        seed=11,
    ).expect("cvnn")


def bounds_for(payoff: PayoffKind, family: str = "gbm") -> dict[str, BoundSpec]:
    bounds = FAMILY_BOUNDS[family]
    return {**bounds, "strike": STRIKE_BOUNDS.get(payoff, bounds["strike"])}


def pricer_config(
    payoff: PayoffKind = PayoffKind.TERMINAL, family: str = "gbm", *,
    sampling: str = "pseudo", spec: object = BASKET_SPEC,
) -> GbmCVNNPricerConfig:
    model = ModelKind(FAMILY_MODEL[family])
    basket = spec if family == "basket" else None
    closed = has_closed_form_mean(model, payoff, combine=basket.combine if basket else None)
    mean_ok = closed and payoff not in (PayoffKind.DIGITAL, PayoffKind.CLIQUET)
    curves = {"term": term_of(STEPS)} if family == "term" else {}
    if basket is not None:
        curves["basket"] = basket
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS,
        mc_seed=QMC_SEED if sampling == "sobol_bb" else 7, implementation="cuda",
        payoff=payoff.value, model=model.value, sampling=sampling,
        normalization="mean" if mean_ok else "none", **KNOBS.get(payoff, {}), **curves,
    ).expect("sim")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds_for(payoff, family),
                               cvnn=production_cvnn(), normalize_inputs=True)


def train_steps(
    pricer: GbmCVNNPricer, n: int, *, batch: int = BATCH, chunk: int = CHUNK
) -> tuple[np.ndarray, list[float]]:
    """``n`` single-batch train calls, each timed to a synchronised end."""
    cfg = build_training_config(
        num_batches=1, batch_size=batch, learning_rate=1e-3, contract_chunk=chunk
    ).expect("training config")
    losses, seconds = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = pricer.train(cfg).expect("train")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(result.final_loss)
    return np.asarray(losses), seconds


def phase_train(
    device: torch.device, payoff: PayoffKind, label: str, family: str = "gbm", *,
    sampling: str = "pseudo", group: str | None = None,
) -> GbmCVNNPricer:
    """3 steps at the production batch; ``group`` (default: the payoff's
    kernel branch) must launch once per chunk."""
    pricer = GbmCVNNPricer.create(pricer_config(payoff, family, sampling=sampling),
                                  device=device).expect("create")
    branch = group or group_of(family, branch_of(family, payoff))
    before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    losses, seconds = train_steps(pricer, 3)
    launched = gbm_cuda.LAUNCHES_BY_BRANCH[branch] - before
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if launched != 3 * BATCH // CHUNK:
        raise AssertionError(f"{branch} kernel launched {launched} times in 3 steps, "
                             f"want {3 * BATCH // CHUNK}")
    snap = pricer.snapshot()
    phase(label, model=snap.sim.model.value, payoff=payoff.value,
          sampling=snap.sim.sampling.value, inputs=len(FAMILY_CONTRACT[family].model_fields),
          engine=snap.sim.implementation.value, normalization=snap.sim.normalization.value,
          stream_version=snap.cuda_stream_version, kernel=branch,
          losses=losses.tolist(), launches=launched, step_seconds=[round(s, 4) for s in seconds],
          median_step_s=f"{statistics.median(seconds):.4f}",
          paths_per_contract=ROWS * COLS, batch=BATCH, chunk=CHUNK)
    return pricer


def phase_resume(device: torch.device, pricer: GbmCVNNPricer, label: str) -> None:
    resumed = GbmCVNNPricer.create(pricer.snapshot(), device=device).expect("resume")
    a, _ = train_steps(pricer, 2)
    b, _ = train_steps(resumed, 2)
    if not np.array_equal(a, b):
        raise AssertionError(f"resume is not bit-exact: {a} vs {b}")
    phase(label, continued=a.tolist(), resumed=b.tolist(), bit_equal=True)


def held_out(payoff: PayoffKind, n: int, family: str = "gbm") -> np.ndarray:
    sampler = SobolSampler.create(FAMILY_CONTRACT[family], bounds_for(payoff, family),
                                  SobolConfig(seed=7)).expect("sampler")
    return sampler.sample_array(n, device="cpu", start=1 << 20).numpy()


def check_prices(pricer: GbmCVNNPricer, batch: np.ndarray, device: torch.device) -> object:
    """Finite puts; NaN calls exactly where E[u] has no closed form; else
    call − put = df·(E[u] − K) to 1e-5, relative to the largest of the terms
    (the parity term, the strike and the put, whose float32 rounding the
    difference carries), with E[u] the payoff's own mean as the pricer
    evaluates it on the card and df at the curves' mean rate."""
    sim = pricer.snapshot().sim
    pred = pricer.predict_price(batch)
    if sim.payoff in AMERICAN_PAYOFFS:  # the learned side finite, the other NaN
        learned, other = ((pred.call, pred.put) if sim.payoff == PayoffKind.AMERICAN_CALL
                          else (pred.put, pred.call))
        if not (np.all(np.isfinite(learned)) and np.all(np.isnan(other))):
            raise AssertionError(f"{sim.payoff.value}: put {pred.put}, call {pred.call}")
        return pred
    if not np.all(np.isfinite(pred.put)):
        raise AssertionError(f"{sim.payoff.value}: non-finite puts {pred.put}")
    combine = sim.basket.combine if sim.basket is not None else None
    if not has_closed_form_mean(sim.model, sim.payoff, combine=combine):
        if not np.all(np.isnan(pred.call)):
            raise AssertionError(f"{sim.payoff.value}: calls should be NaN, got {pred.call}")
        return pred
    mean = make_mean_target(sim)(torch.from_numpy(batch).to(device)).double().cpu().numpy()
    b = batch.astype(np.float64)
    mean_rate = 1.0 if sim.term is None else sim.term.effective_factors(sim.timesteps)[1]
    parity = np.exp(-b[:, 3] * mean_rate * b[:, 2]) * (mean - b[:, 1])
    gap = np.abs((pred.call - pred.put) - parity)
    scale = np.maximum(np.maximum(np.abs(parity), b[:, 1]), np.abs(pred.put))
    if not np.all(gap <= 1e-5 * scale):
        raise AssertionError(f"{sim.payoff.value}: call − put misses df·(E[u] − K) by "
                             f"{gap.max():.3g}")
    return pred


def phase_serve(pricer: GbmCVNNPricer, device: torch.device, label: str) -> dict[int, float]:
    sim = pricer.snapshot().sim
    payoff, family = sim.payoff, family_of(sim)
    rows = held_out(payoff, 64, family)
    p50 = {}
    for n in (1, 7, 64):
        batch = rows[:n]
        pred = check_prices(pricer, batch, device)
        padded = pricer.predict_price(batch, pad_to_bucket=True)
        if not (np.array_equal(pred.put, padded.put, equal_nan=True)
                and np.array_equal(pred.call, padded.call, equal_nan=True)):
            raise AssertionError(f"pad_to_bucket changed the prices at N={n}")
        times = []
        for _ in range(20):
            start = time.perf_counter()
            pricer.predict_price(batch)
            times.append((time.perf_counter() - start) * 1e3)
        p50[n] = statistics.median(times)
    extra = {}
    if payoff == PayoffKind.ASIAN_ARITHMETIC and family == "gbm":
        # the float32 series g(g^N − 1)/(g − 1) the pricer evaluates, against
        # float64: its cancellation costs ~1.2e-7/|g − 1| relative
        b = torch.from_numpy(rows)
        f32 = expected_underlier_mean(b.to(device), timesteps=STEPS, payoff=payoff,
                                      dtype=torch.float32).double().cpu()
        f64 = expected_underlier_mean(b.double(), timesteps=STEPS, payoff=payoff,
                                      dtype=torch.float64)
        extra["mean_f32_vs_f64_max_rel"] = f"{float(((f32 - f64) / f64).abs().max()):.3e}"
    phase(label, model=sim.model.value, payoff=payoff.value, held_out_skip=1 << 20,
          puts_n64=np.round(pred.put[:4], 4).tolist(), calls_n64=np.round(pred.call[:4], 4).tolist(),
          p50_ms={k: round(v, 4) for k, v in p50.items()}, pad_bit_equal=True, parity_ok=True,
          **extra)
    return p50


def phase_payoffs(device: torch.device) -> None:
    kinds = [p for p in PayoffKind
             if not p.value.startswith("american")
             and p not in (PayoffKind.TERMINAL, PayoffKind.ASIAN_ARITHMETIC)]
    batch = held_out(PayoffKind.TERMINAL, 8)
    for payoff in kinds:
        pricer = GbmCVNNPricer.create(pricer_config(payoff), device=device).expect(payoff.value)
        branch = gbm_cuda.branch_of(payoff)
        before = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
        losses, seconds = train_steps(pricer, 1, batch=PAYOFF_BATCH, chunk=PAYOFF_BATCH)
        launched = gbm_cuda.LAUNCHES_BY_BRANCH[branch] - before
        snap = pricer.snapshot()
        key = "gbm_cliquet" if payoff == PayoffKind.CLIQUET else "gbm"
        if snap.sim.implementation.value != "cuda":
            raise AssertionError(f"{payoff.value}: engine {snap.sim.implementation.value}")
        if snap.cuda_stream_version != gbm_cuda.CUDA_STREAM_VERSIONS[key] or launched != 1:
            raise AssertionError(f"{payoff.value}: stream v{snap.cuda_stream_version}, "
                                 f"{branch} launches {launched}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{payoff.value}: non-finite loss {losses}")
        own = batch.copy()
        if payoff in STRIKE_BOUNDS:
            own = held_out(payoff, 8)
        pred = check_prices(pricer, own, device)
        phase("payoffs", payoff=payoff.value, engine="cuda",
              stream=f"{key}_v{snap.cuda_stream_version}", branch=branch,
              launches=launched, loss=float(losses[0]), step_s=round(seconds[0], 4),
              puts=np.round(pred.put[:3], 5).tolist(),
              calls="NaN" if np.all(np.isnan(pred.call)) else "parity")


# Phase 10's pricers: one payoff per kernel branch of each family (Heston's
# TERMINAL branch is phase 9's) and the routes through TERMINAL.
FAMILY_PAYOFFS = (PayoffKind.TERMINAL, PayoffKind.DIGITAL, PayoffKind.FORWARD_START,
                  PayoffKind.BARRIER_UP_OUT, PayoffKind.LOOKBACK_FLOAT_PUT,
                  PayoffKind.VARIANCE_SWAP, PayoffKind.ASIAN_GEOMETRIC)


def phase_families(device: torch.device) -> None:
    for family in FAMILIES:
        for payoff in FAMILY_PAYOFFS:
            if family == "heston" and payoff == PayoffKind.TERMINAL:
                continue
            name = f"{family}/{payoff.value}"
            pricer = GbmCVNNPricer.create(pricer_config(payoff, family),
                                          device=device).expect(name)
            group = group_of(family, branch_of(family, payoff))
            before = gbm_cuda.LAUNCHES_BY_BRANCH[group]
            losses, seconds = train_steps(pricer, 1, batch=PAYOFF_BATCH, chunk=PAYOFF_BATCH)
            launched = gbm_cuda.LAUNCHES_BY_BRANCH[group] - before
            snap = pricer.snapshot()
            key = FAMILY_STREAM[family]
            if snap.sim.implementation.value != "cuda":
                raise AssertionError(f"{name}: engine {snap.sim.implementation.value}")
            if snap.cuda_stream_version != gbm_cuda.CUDA_STREAM_VERSIONS[key] or launched != 1:
                raise AssertionError(f"{name}: stream v{snap.cuda_stream_version}, "
                                     f"{group} launches {launched}")
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"{name}: non-finite loss {losses}")
            pred = check_prices(pricer, held_out(payoff, 8, family), device)
            phase("families", model=snap.sim.model.value, curved=family == "term",
                  payoff=payoff.value, engine="cuda", stream=f"{key}_v{snap.cuda_stream_version}",
                  branch=group, launches=launched,
                  normalization=snap.sim.normalization.value, loss=float(losses[0]),
                  step_s=round(seconds[0], 4), puts=np.round(pred.put[:3], 5).tolist(),
                  calls="NaN" if np.all(np.isnan(pred.call)) else "parity")


# --------------------------------------------------------------------------
# 12-16. baskets and QMC path sampling
# --------------------------------------------------------------------------

BASKET_CASE_CONTRACTS = 8  # contracts per kernel-vs-twin case
BASKET_TIMED_CONTRACTS = 32  # kernel, twin and bound of each timed basket group
BASKET_TIMED = {  # branch group -> (payoff, knobs), timed on the 3-asset arithmetic basket
    "basket_terminal": (PayoffKind.TERMINAL, {}),
    "basket_barrier": (PayoffKind.BARRIER_UP_OUT, dict(barrier_rel=1.25)),
    "basket_lookback": (PayoffKind.LOOKBACK_FIXED_CALL, {}),
    "basket_variance": (PayoffKind.VARIANCE_SWAP, {}),
    "basket_asian": (PayoffKind.ASIAN_ARITHMETIC, {}),
    "basket_forward": (PayoffKind.FORWARD_START, dict(forward_start_step=FORWARD_STEP)),
}


def spec_of(assets: int, combine: str) -> object:
    """The bench's 3-asset basket, or 1 asset, or 8 (equal weights,
    correlation 0.3/(1 + |i − j|), spread multipliers)."""
    if assets == 3:
        return BASKET_SPEC if combine == "arithmetic" else GEOMETRIC_SPEC
    corr = tuple(tuple(1.0 if i == j else 0.3 / (1 + abs(i - j)) for j in range(assets))
                 for i in range(assets))
    return build_basket_spec(
        weights=(1.0 / assets,) * assets, correlation=corr, combine=combine,
        spot_multipliers=tuple(1.0 + 0.02 * a for a in range(assets)),
        vol_multipliers=tuple(1.2 - 0.05 * a for a in range(assets)),
    ).expect("spec")


def basket_cases() -> list[tuple[str, PayoffKind, dict[str, object]]]:
    """(group, payoff, kwargs) of the basket kernel's cases: every payoff of
    every branch group under both combines at 3 assets (antithetic), and one
    payoff per branch group at 1 and 8 assets."""
    all_payoffs = [PayoffKind.TERMINAL, PayoffKind.DIGITAL, PayoffKind.FORWARD_START,
                   PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT,
                   *sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value), PayoffKind.VARIANCE_SWAP,
                   PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC]
    cases = []
    for combine in ("arithmetic", "geometric"):
        for assets, payoffs, half in ((3, all_payoffs, ROWS // 2),
                                      (1, [p for p, _ in BASKET_TIMED.values()], None),
                                      (8, [p for p, _ in BASKET_TIMED.values()], None)):
            spec = spec_of(assets, combine)
            for payoff in payoffs:
                kw = dict(rows=ROWS, cols=COLS, timesteps=STEPS, spec=spec,
                          antithetic_half=half, **KNOBS.get(payoff, {}))
                cases.append((f"basket_{basket_cuda.basket_branch(payoff, spec)}", payoff, kw))
    return cases


def phase_basket_kernel(
    device: torch.device, per_step: dict[str, float], max_sm_hz: float
) -> dict[str, dict[str, object]]:
    """The basket kernel against its twin on every case at 8 contracts of
    2048 x 512 x 16 (rtol 2e-5; knocks and signs flipped on at most 1e-5 of
    the paths), then each branch group timed at 32 contracts (CUDA events;
    the twin's call) beside its bound and its SASS cap share, and
    TERMINAL again at the main path's 256 contracts (checked there too; the
    kernel record keeps that shape)."""
    record = {g: {"max_abs_err": 0.0, "max_rel": 0.0, "flips": 0, "cases": 0}
              for g in BASKET_TIMED}
    for group, payoff, kw in basket_cases():
        found = compare(device, payoff, BASKET_CASE_CONTRACTS, "basket", **kw)
        r = record[group]
        r.update(max_abs_err=max(r["max_abs_err"], found["max_abs_err"]),
                 max_rel=max(r["max_rel"], found["max_rel"]),
                 flips=r["flips"] + found["flips"], cases=r["cases"] + 1)
    timed = [(group, BASKET_TIMED_CONTRACTS) for group in BASKET_TIMED]
    timed.append(("basket_terminal", CHUNK))  # the main path's shape: the training chunk
    for group, contracts in timed:
        payoff, extra = BASKET_TIMED[group]
        kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, spec=BASKET_SPEC, **extra)
        found = compare(device, payoff, contracts, "basket", **kw)
        params, keys = kernel_inputs(device, contracts, 1, "basket")
        kernel, _ = kernel_and_twin("basket", payoff, kw)
        ms = cuda_ms(lambda: kernel(params, keys))
        branch = group.removeprefix("basket_")
        bound, bound_by = basket_bound_ms(contracts, STEPS, 3, branch, False)
        path_steps = contracts * ROWS * COLS * STEPS
        cap = LANES_PER_CLOCK * max_sm_hz / per_step[group]
        r = record[group]
        r.update(max_abs_err=max(r["max_abs_err"], found["max_abs_err"]),
                 max_rel=max(r["max_rel"], found["max_rel"]), flips=r["flips"] + found["flips"],
                 ms=ms, plain_ms=found["plain_ms"], bound_ms=bound, bound_by=bound_by)
        phase("kernel-basket", branch=group, cases=r["cases"],
              max_rel_diff=f"{r['max_rel']:.3e}", max_abs_err=f"{r['max_abs_err']:.3e}",
              flips=r["flips"], rtol=KERNEL_RTOL, assets=3, combine="arithmetic",
              shape=f"{contracts}x{ROWS}x{COLS}x{STEPS}", timed=payoff.value,
              kernel_ms=f"{ms:.3f}", plain_ms=f"{found['plain_ms']:.3f}",
              bound_ms=f"{bound:.3f}", bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
              sass_per_path_step=round(per_step[group], 3),
              kernel_path_steps_per_s=f"{path_steps / ms * 1e3:.4e}",
              **cap_share(path_steps / ms * 1e3, cap))
        del params, keys
        torch.cuda.empty_cache()
    return record


QMC_CONTRACTS = 4  # contracts per generator case at the production 2048 x 512 points
QMC_CASES = [(STEPS, 1, 0), (STEPS, 2, 37 * COLS), (STEPS, 3, 0), (32, 3, 5 * COLS),
             (8, 1, 1021), (64, 1, 99)]
# #13 at the shape the main path launches it: the SOBOL_BB family steps of
# phase 16 (PAYOFF_BATCH contracts) at one, two and three factors
QMC_LAUNCHED_FACTORS = (1, 2, 3)
WORD_ULPS = 2  # identity-bridge normals: kernel vs twin, in float32 ulps (log1pf)
BRIDGE_ATOL = 1e-5  # bridged normals: the ulps above through T multiply-adds, |B| <= 1


def qmc_inputs(device: torch.device, contracts: int, steps: int, factors: int,
               start: int) -> dict[str, object]:
    """The generator's arguments for ``contracts`` seeded keys."""
    keys = rng.fold_in(rng.prng_key(QMC_SEED, device), torch.arange(contracts, device=device))
    sdims, dirs, shift, pad_keys = qmc._draw_tables(keys, steps, factors, QMC_SEED)
    pad = None
    if sdims < steps * factors:
        pad = qmc.qmc_pad_normals(pad_keys, range(sdims, steps * factors), rows=ROWS,
                                  cols=COLS, row_offset=start // COLS)
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(steps), dtype=torch.float32,
                             device=device)
    return dict(directions=dirs, shift=shift, bridge=bridge, start=start, timesteps=steps,
                factors=factors, count=ROWS * COLS, pad=pad)


def walk_scalars(device: torch.device, contracts: int) -> tuple[torch.Tensor, ...]:
    c = torch.tensor(ORACLE_CONTRACTS, dtype=torch.float32, device=device)[
        torch.arange(contracts, device=device) % 3]
    spot, _, maturity, rate, div, vol = (c[:, i] for i in range(6))
    dt = maturity / STEPS
    return torch.log(spot), (rate - div - 0.5 * vol * vol) * dt, vol * torch.sqrt(dt)


# (timesteps, start, count) of the fused walk's cases: the sparse walk at T =
# 16, 64, 8 and 32 (off the quad and block grid, ragged ends), the dense walk
# at T = 7
WALK_CASES = [(STEPS, 3 * COLS, ROWS * COLS), (7, 3 * COLS, ROWS * COLS),
              (64, 3 * COLS, ROWS * COLS), (8, 1, ROWS * COLS - 3),
              (32, 1021, ROWS * COLS - 1), (STEPS, 99, 4097)]


def walk_bridge(bridge: torch.Tensor) -> torch.Tensor:
    """The bridge as the main path hands it to ``walk_acc``: on the CPU in a
    tree whose walk reads its zeros there (``qmc_cuda.sparse_walk``), else on
    the card."""
    return bridge.cpu() if hasattr(qmc_cuda, "sparse_walk") else bridge


def bridge_choice() -> bool:
    """Whether this tree's #13 has a sparse and a dense instantiation
    (``bridge_normals(..., dense=)``; an older tree has the dense one only)."""
    return "dense" in inspect.signature(qmc_cuda.bridge_normals).parameters


def bridge_instantiation(bridge: torch.Tensor, steps: int) -> str:
    """The instantiation of #13 that ``bridge_normals`` launches."""
    return "sparse" if qmc_cuda.sparse_walk(bridge, steps) else "dense"


def main_bridge_args(kw: dict[str, object]) -> dict[str, object]:
    """``bridge_normals``' arguments as the main path passes them: the bridge
    on the CPU where the wrapper reads its zeros there, else on the card."""
    return dict(kw, bridge=kw["bridge"].cpu()) if bridge_choice() else kw


def phase_qmc_kernel(device: torch.device, qmc_sass: dict[str, object],
                     max_sm_hz: float) -> dict[str, dict[str, object]]:
    """Kernel #13 against its twin for F = 1, 2, 3, a padded case (T·F >
    64) and T = 8 and 64: the Sobol words equal, the normals (identity
    bridge) within ``WORD_ULPS`` ulps, the bridged normals within
    ``BRIDGE_ATOL``, and in a tree with a sparse instantiation the output
    equal bit for bit to the twin's and to the dense instantiation's; kernel
    #14 equal bit for bit to #13 walked by the torch scan and to its twin
    (``WALK_CASES``); each timed at 4 contracts of 2048 x 512 points (CUDA
    events; the twin's second call) beside its bound, #13 also at the shape
    the main path launches it (``PAYOFF_BATCH``, F = 1, 2, 3; its
    dense instantiation beside it), #14 at the training chunk, each with its
    SASS a point (``qmc_sass``) against the instruction cap."""
    record = {"qmc_bridge": {"max_abs_err": 0.0, "cases": 0},
              "qmc_walk": {"max_abs_err": 0.0, "cases": 0}}
    for steps, factors, start in QMC_CASES:
        kw = qmc_inputs(device, QMC_CONTRACTS, steps, factors, start)
        sdims = kw["directions"].shape[0]
        words = torch.empty((QMC_CONTRACTS, sdims, ROWS * COLS), dtype=torch.int32,
                            device=device)
        got = qmc_cuda.bridge_normals(**main_bridge_args(kw), words_out=words)
        want_words = qmc_cuda.sobol_words(kw["directions"], kw["shift"], start, ROWS * COLS)
        if not torch.equal(words.to(torch.int64) & rng.MASK32, want_words):
            raise AssertionError(f"qmc words differ at T={steps} F={factors}")
        del words, want_words
        eye = dict(kw, bridge=torch.eye(steps, dtype=torch.float32, device=device))
        z_kernel, z_twin = qmc_cuda.bridge_normals(**eye), qmc_cuda.bridge_normals_plain(**eye)
        ulp = torch.abs(torch.nextafter(z_twin, torch.full_like(z_twin, math.inf)) - z_twin)
        ulps = float(((z_kernel - z_twin).abs() / ulp).max())
        del z_kernel, z_twin, ulp
        want = qmc_cuda.bridge_normals_plain(**kw)
        err = float((got - want).abs().max())
        if ulps > WORD_ULPS or err > BRIDGE_ATOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"qmc bridge T={steps} F={factors}: {ulps} ulps, err {err}")
        twin_equal, exact = bool(torch.equal(got, want)), {}
        if bridge_choice():
            dense = qmc_cuda.bridge_normals(**kw, dense=True)
            exact = dict(instantiation=bridge_instantiation(kw["bridge"], steps),
                         bit_equal_to_dense=bool(torch.equal(got, dense)))
            del dense
            if not (twin_equal and exact["bit_equal_to_dense"]):
                raise AssertionError(f"qmc bridge T={steps} F={factors} start {start}: "
                                     f"{exact['instantiation']} output not the twin's and the "
                                     "dense instantiation's bit for bit")
        r = record["qmc_bridge"]
        r.update(max_abs_err=max(r["max_abs_err"], err), cases=r["cases"] + 1)
        phase("kernel-qmc", kernel="qmc_bridge", timesteps=steps, factors=factors,
              padded_dims=steps * factors - sdims, start=start, words_equal=True,
              normal_max_ulps=ulps, ulps_allowed=WORD_ULPS, bridged_max_abs_err=f"{err:.3e}",
              atol=BRIDGE_ATOL, bit_equal_to_twin=twin_equal, **exact)
        del got, want
    for steps, start, count in WALK_CASES:
        kw = dict(qmc_inputs(device, QMC_CONTRACTS, steps, 1, start), count=count)
        scalars = walk_scalars(device, QMC_CONTRACTS)
        got = qmc_cuda.walk_acc(kw["directions"], kw["shift"], walk_bridge(kw["bridge"]),
                                start, *scalars, timesteps=steps, count=count)
        eff = qmc_cuda.bridge_normals(**kw)[:, :, 0]
        logx = torch.zeros_like(got) + scalars[0][:, None]
        acc = torch.zeros_like(got)
        for t in range(steps):
            logx = logx + scalars[1][:, None] + scalars[2][:, None] * eff[:, t]
            acc = acc + logx
        if not torch.equal(got, acc):
            raise AssertionError(f"qmc walk T={steps}: {int((got != acc).sum())} sums differ "
                                 "from the bridge kernel walked by the scan")
        twin = qmc_cuda.walk_acc_plain(kw["directions"], kw["shift"], kw["bridge"], start,
                                       *scalars, timesteps=steps, count=count)
        if not torch.equal(got, twin):
            raise AssertionError(f"qmc walk T={steps} start {start}: {int((got != twin).sum())} "
                                 "sums differ from the twin's")
        sparse = hasattr(qmc_cuda, "sparse_walk") and qmc_cuda.sparse_walk(kw["bridge"], steps)
        r = record["qmc_walk"]
        r.update(cases=r["cases"] + 1)
        phase("kernel-qmc", kernel="qmc_walk", timesteps=steps, start=start, count=count,
              walk="sparse" if sparse else "dense", bit_equal_to_bridge_plus_scan=True,
              bit_equal_to_twin=True)
        del got, acc, eff, twin
    kw = qmc_inputs(device, QMC_CONTRACTS, STEPS, 1, 0)
    bridge_args = {k: kw[k] for k in ("directions", "shift", "bridge", "start")}
    main_args = dict(bridge_args, bridge=walk_bridge(kw["bridge"]))
    scalars = walk_scalars(device, QMC_CONTRACTS)
    timed = {
        "qmc_bridge": (lambda: qmc_cuda.bridge_normals(**main_bridge_args(kw)),
                       lambda: qmc_cuda.bridge_normals_plain(**kw),
                       qmc_bound_ms(QMC_CONTRACTS, STEPS, 1, ROWS * COLS)),
        "qmc_walk": (lambda: qmc_cuda.walk_acc(**main_args, log_spot=scalars[0],
                                               drift=scalars[1], vol_sdt=scalars[2],
                                               timesteps=STEPS, count=ROWS * COLS),
                     lambda: qmc_cuda.walk_acc_plain(*bridge_args.values(), *scalars,
                                                     timesteps=STEPS, count=ROWS * COLS),
                     qmc_bound_ms(QMC_CONTRACTS, STEPS, 1, ROWS * COLS, walk=True)),
    }
    for name, (kernel, twin, (bound, bound_by)) in timed.items():
        ms = cuda_ms(kernel)
        twin()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        twin()
        stop.record()
        stop.synchronize()
        record[name].update(ms=ms, plain_ms=start.elapsed_time(stop), bound_ms=bound,
                            bound_by=bound_by)
        phase("kernel-qmc-time", kernel=name, shape=f"{QMC_CONTRACTS}x{ROWS}x{COLS}x{STEPS}",
              kernel_ms=f"{ms:.3f}", plain_ms=f"{record[name]['plain_ms']:.3f}",
              bound_ms=f"{bound:.4f}", bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
              points_per_s=f"{QMC_CONTRACTS * ROWS * COLS / ms * 1e3:.4e}")
    bridge_split = qmc_sass.get("bridge", {})
    shapes = [(QMC_CONTRACTS, 1)] + [(PAYOFF_BATCH, f) for f in QMC_LAUNCHED_FACTORS]
    for contracts, factors in shapes:
        big = qmc_inputs(device, contracts, STEPS, factors, 0)
        ms = cuda_ms(lambda: qmc_cuda.bridge_normals(**main_bridge_args(big)), iters=5)
        dense = {}
        if bridge_choice():
            dense = dict(instantiation=bridge_instantiation(big["bridge"], STEPS), dense_ms=(
                f"{cuda_ms(lambda: qmc_cuda.bridge_normals(**big, dense=True), iters=5):.3f}"))
        bound, bound_by = qmc_bound_ms(contracts, STEPS, factors, ROWS * COLS)
        points = contracts * ROWS * COLS
        cap = {}
        if factors == 1 and "total" in bridge_split:
            per_point = LANES_PER_CLOCK * max_sm_hz / bridge_split["total"]
            cap = dict(sass_per_point=bridge_split["total"],
                       **cap_share(points / ms * 1e3, per_point))
        phase("kernel-qmc-time", kernel="qmc_bridge",
              shape=f"{contracts}x{ROWS}x{COLS}x{STEPS}", factors=factors, kernel_ms=f"{ms:.3f}",
              **dense, bound_ms=f"{bound:.4f}", bound_by=bound_by,
              share_of_bound=f"{bound / ms:.4f}", points_per_s=f"{points / ms * 1e3:.4e}",
              launched_shape=contracts == PAYOFF_BATCH, **cap)
        del big
        torch.cuda.empty_cache()
    chunk = dict(main_args, shift=kw["shift"].repeat(CHUNK // QMC_CONTRACTS, 1))
    big = tuple(x.repeat(CHUNK // QMC_CONTRACTS) for x in scalars)
    ms = cuda_ms(lambda: qmc_cuda.walk_acc(**chunk, log_spot=big[0], drift=big[1],
                                           vol_sdt=big[2], timesteps=STEPS, count=ROWS * COLS),
                 iters=5)
    bound, bound_by = qmc_bound_ms(CHUNK, STEPS, 1, ROWS * COLS, walk=True)
    points = CHUNK * ROWS * COLS
    cap = {}
    if "total" in qmc_sass:
        per_point = LANES_PER_CLOCK * max_sm_hz / qmc_sass["total"]
        cap = dict(sass_per_point=qmc_sass["total"],
                   instruction_cap_points_per_s=f"{per_point:.4e}",
                   **cap_share(points / ms * 1e3, per_point))
    phase("kernel-qmc-time", kernel="qmc_walk", shape=f"{CHUNK}x{ROWS}x{COLS}x{STEPS}",
          kernel_ms=f"{ms:.3f}", bound_ms=f"{bound:.3f}", bound_by=bound_by,
          share_of_bound=f"{bound / ms:.4f}", points_per_s=f"{points / ms * 1e3:.4e}", **cap)
    return record


def mc_z(pay: torch.Tensor, want: float) -> tuple[float, float, float]:
    """(mean, standard error, z) of a ``[P]`` sample against ``want``."""
    pay = pay.double()
    mean, se = float(pay.mean()), float(pay.std() / math.sqrt(pay.numel()))
    return mean, se, z_score(mean, se, want, 0.0)


def gate(label: str, prices: object, oracle: list[tuple[float, float]]) -> list[tuple]:
    """Each contract's MC put and call within 4 SE of ``oracle``'s."""
    found = []
    for i, (put, call) in enumerate(oracle):
        for side, pay, want in (("put", prices.put_payoffs[i], put),
                                ("call", prices.call_payoffs[i], call)):
            mean, se, z = mc_z(pay, want)
            if not z < 4.0:
                raise AssertionError(f"{label} {side} contract {i}: MC {mean:.6f} ± {se:.2e} "
                                     f"vs oracle {want:.6f} (z={z:.2f})")
            found.append((side, round(mean, 5), round(se, 5), round(want, 5), round(z, 3)))
    return found


def phase_oracle_basket_qmc(device: torch.device) -> None:
    """Over 1,048,576 paths per contract, three contracts, normalization
    "none": the geometric basket on the cuda engine against
    ``geometric_basket_price``, a 1-asset arithmetic basket against
    ``black_scholes_price``; SOBOL_BB GBM TERMINAL and geometric Asian against
    ``black_scholes_price`` and ``geometric_asian_price``, SOBOL_BB Heston
    TERMINAL at 32 steps against ``heston_call_price``; each within 4
    standard errors (the per-path standard error, which over-states RQMC's).
    Then the RMSE ratio of pseudo to QMC at an equal budget, the JAX bench's
    (bench.py:879-904): 16 estimates of the ATM call from 16 x 256 paths."""
    contracts = torch.tensor(ORACLE_CONTRACTS, dtype=torch.float32, device=device)
    one = build_basket_spec(weights=(1.0,), correlation=((1.0,),)).expect("one asset")
    cases = [("geometric basket", "basket", GEOMETRIC_SPEC, "pseudo", PayoffKind.TERMINAL,
              STEPS, "basket_terminal"),
             ("1-asset arithmetic basket", "basket", one, "pseudo", PayoffKind.TERMINAL, STEPS,
              "basket_terminal"),
             ("sobol_bb gbm", "gbm", None, "sobol_bb", PayoffKind.TERMINAL, STEPS, None),
             ("sobol_bb gbm", "gbm", None, "sobol_bb", PayoffKind.ASIAN_GEOMETRIC, STEPS,
              "qmc_walk"),
             ("sobol_bb heston", "heston", None, "sobol_bb", PayoffKind.TERMINAL,
              HESTON_ORACLE_STEPS, "qmc_bridge")]
    for label, family, spec, sampling, payoff, steps, group in cases:
        extra = {"basket": spec} if spec is not None else {}
        sim = build_simulation_params(
            timesteps=steps, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=QMC_SEED,
            implementation="cuda", normalization="none", payoff=payoff.value,
            model=FAMILY_MODEL[family], sampling=sampling, **extra,
        ).expect(label)
        base = ORACLE_CONTRACTS if family != "heston" else FAMILY_ORACLE_CONTRACTS["heston"]
        c = torch.tensor(base, dtype=torch.float32, device=device)
        keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), torch.arange(3, device=device))
        before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
        u = make_underlier_simulator(sim, rows=ROWS)(keys, c).reshape(3, -1)
        if group is not None and gbm_cuda.LAUNCHES_BY_BRANCH[group] != before[group] + 1:
            raise AssertionError(f"{label}: the oracle run did not launch {group}")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{label}: non-finite underliers")
        if family == "heston":
            oracle = [family_oracle("heston", row, steps) for row in base]
        elif spec is not None:
            oracle = [(float(p.put), float(p.call)) for p in
                      (analytic.geometric_basket_price(*row, spec=spec) for row in base)]
        elif payoff == PayoffKind.ASIAN_GEOMETRIC:
            oracle = [(float(p.put), float(p.call)) for p in
                      (analytic.geometric_asian_price(*row, timesteps=steps) for row in base)]
        else:
            oracle = [(float(p.put), float(p.call)) for p in
                      (analytic.black_scholes_price(*row) for row in base)]
        prices = terminal_to_prices(u, c, normalize=False, dtype=torch.float32)
        found = gate(f"{label}/{payoff.value}", prices, oracle)
        phase("oracle", family=label, sampling=sampling, payoff=payoff.value, steps=steps,
              engine=sim.implementation.value, paths=u.shape[1], kernel=group,
              side_mc_se_oracle_z=repr(found))
    del u
    spot, strike, maturity, rate, div, vol = ORACLE_CONTRACTS[0]
    truth = float(analytic.black_scholes_price(*ORACLE_CONTRACTS[0]).call)
    c = contracts[:1]
    df = math.exp(-rate * maturity)
    errors = {}
    for sampling in (SamplingKind.PSEUDO, SamplingKind.SOBOL_BB):
        est = []
        for i in range(16):
            key = rng.fold_in(rng.prng_key(77, device), torch.tensor([i], device=device))
            rows = simulate_terminal_rows(key, c, timesteps=STEPS, rows=16, cols=256,
                                          dtype=torch.float32, scheme=PathScheme.LOG_EULER,
                                          sampling=sampling, mc_seed=QMC_SEED)
            est.append(df * float(torch.clamp(rows - strike, min=0.0).double().mean()))
        errors[sampling.value] = math.sqrt(sum((e - truth) ** 2 for e in est) / len(est))
    phase("oracle-qmc-rmse", truth=round(truth, 6), reps=16, paths_per_rep=16 * 256,
          rmse_pseudo=f"{errors['pseudo']:.4e}", rmse_sobol_bb=f"{errors['sobol_bb']:.4e}",
          rmse_ratio_pseudo_over_qmc=f"{errors['pseudo'] / max(errors['sobol_bb'], 1e-12):.2f}")


# Phase 16's pricers: (label, family, spec, sampling, payoff, kernel group)
FAMILY_PRICERS = [
    ("geometric basket", "basket", GEOMETRIC_SPEC, "pseudo", PayoffKind.TERMINAL,
     "basket_terminal"),
    ("basket", "basket", BASKET_SPEC, "pseudo", PayoffKind.BARRIER_UP_OUT, "basket_barrier"),
    ("basket", "basket", BASKET_SPEC, "pseudo", PayoffKind.ASIAN_ARITHMETIC, "basket_asian"),
    ("basket", "basket", BASKET_SPEC, "pseudo", PayoffKind.LOOKBACK_FLOAT_PUT, "basket_lookback"),
    ("geometric basket", "basket", GEOMETRIC_SPEC, "pseudo", PayoffKind.VARIANCE_SWAP,
     "basket_variance"),
    ("basket", "basket", BASKET_SPEC, "pseudo", PayoffKind.FORWARD_START, "basket_forward"),
    ("sobol_bb gbm", "gbm", None, "sobol_bb", PayoffKind.ASIAN_ARITHMETIC, "qmc_bridge"),
    ("sobol_bb heston", "heston", None, "sobol_bb", PayoffKind.TERMINAL, "qmc_bridge"),
    ("sobol_bb basket", "basket", BASKET_SPEC, "sobol_bb", PayoffKind.TERMINAL, "qmc_bridge"),
    ("sobol_bb merton", "merton", None, "sobol_bb", PayoffKind.TERMINAL, "qmc_bridge"),
]


def phase_basket_qmc_families(device: torch.device) -> None:
    """One step at batch 64 (one chunk) per pricer of ``FAMILY_PRICERS``:
    the engine and stream recorded (SOBOL_BB: the threefry engine, version
    0), its kernel launched once, a finite loss and puts, calls NaN exactly
    where E[u] has no closed form. The SOBOL_BB chunk's normals tensor
    ``[64, T, F, 2048·512]`` float32 is printed (12.9 GB at F = 3)."""
    for label, family, spec, sampling, payoff, group in FAMILY_PRICERS:
        cfg = pricer_config(payoff, family, sampling=sampling, spec=spec)
        pricer = GbmCVNNPricer.create(cfg, device=device).expect(label)
        before = gbm_cuda.LAUNCHES_BY_BRANCH[group]
        losses, seconds = train_steps(pricer, 1, batch=PAYOFF_BATCH, chunk=PAYOFF_BATCH)
        launched = gbm_cuda.LAUNCHES_BY_BRANCH[group] - before
        snap = pricer.snapshot()
        engine = "xla" if sampling == "sobol_bb" else "cuda"
        version = 0 if sampling == "sobol_bb" else gbm_cuda.CUDA_STREAM_VERSIONS["basket_gbm"]
        if snap.sim.implementation.value != engine or snap.cuda_stream_version != version:
            raise AssertionError(f"{label}/{payoff.value}: engine {snap.sim.implementation.value}"
                                 f" stream v{snap.cuda_stream_version}")
        if launched != 1 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{label}/{payoff.value}: {group} launches {launched}, "
                                 f"loss {losses}")
        pred = check_prices(pricer, held_out(payoff, 8, family), device)
        factors = {"heston": 2, "basket": 3}.get(family, 1)
        normals_gb = PAYOFF_BATCH * STEPS * factors * ROWS * COLS * 4 / 1e9
        phase("families-basket-qmc", family=label, model=snap.sim.model.value,
              sampling=sampling, payoff=payoff.value, engine=engine, stream_version=version,
              kernel=group, launches=launched, chunk=PAYOFF_BATCH,
              qmc_normals_gb=round(normals_gb, 2) if sampling == "sobol_bb" else 0,
              normalization=snap.sim.normalization.value, loss=float(losses[0]),
              step_s=round(seconds[0], 4), puts=np.round(pred.put[:3], 5).tolist(),
              calls="NaN" if np.all(np.isnan(pred.call)) else "parity")
        del pricer
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 17-21. American (LSMC) pricing on GBM
# --------------------------------------------------------------------------

AMERICAN_SOURCE = "spectralmc_tpu_torch/csrc/american_paths.cu"
AMERICAN_REPLACES = {"american_gbm": "spectralmc_tpu/ops/gbm_pallas.py:1656"}
# The LSMC backward (csrc/lsmc_backward.cuh, built as lsmc_backward.cu and
# lsmc_two_state.cu): per route and mode, the function it computes. The
# two-state mode computes the JAX package's XLA backward with extra_rows
# (its Pallas kernels refuse a second state).
LSMC_SOURCE = "spectralmc_tpu_torch/csrc/lsmc_backward.cuh"
LSMC_REPLACES = {"lsmc_backward": "spectralmc_tpu/ops/lsmc_pallas.py:152",
                 "lsmc_backward_streamed": "spectralmc_tpu/ops/lsmc_pallas.py:414",
                 "lsmc_two_state": "spectralmc_tpu/ops/american.py:104",
                 "lsmc_two_state_streamed": "spectralmc_tpu/ops/american.py:104"}
# The sweep/solve pair this backward replaced (backward version 3's first
# kernels), as PERF.md times them on an H100 80GB HBM3 at 700 W: the
# training chunk and the streamed shape; and the torch estimator the
# two-state mode replaced, per training chunk.
SWEEP_SOLVE_MS = {"lsmc_backward": 44.604, "lsmc_backward_streamed": 3.292}
TORCH_ESTIMATOR_BEFORE_MS = 2299.7
AMERICAN_CONTRACTS = 4  # contracts per kernel-vs-twin case
# (timesteps, exercise_every, antithetic half) of the monitor kernel's cases
AMERICAN_CASES = [(STEPS, 1, None), (STEPS, 2, None), (STEPS, 4, None), (12, 3, None),
                  (STEPS, 1, ROWS // 2), (STEPS, 8, None), (12, 6, ROWS // 2)]
# The backward's shapes: the fused TPU kernel's (up to 2^20 paths a contract,
# the resident route here) and the streamed one's (the JAX bench's 4,194,304
# paths, past the resident grid's capacity)
LSMC_SHAPES = {"lsmc_backward": (ROWS, COLS), "lsmc_backward_streamed": (16384, 256)}
LSMC_FLIP_SHARE = 1e-5  # kernel vs twin: paths whose exercise date may differ
LSMC_MEAN_RTOL = 1e-5  # kernel vs twin: the mean cashflow
TORCH_FLIP_SHARE = 0.02  # kernel vs the torch estimator (tests/test_lsmc_pallas.py:83-110)
TORCH_MEAN_RTOL = 2e-3
LSMC_DEGREE = 5
# The monitor kernel's op model per path: the round keys (PHILOX_KEY_OPS),
# its draws (DRAW_OPS each), the log-price update per step
# (UNIT_OPS["terminal"]) and one exp per monitor date; bytes: the contract
# and key in, n_monitor floats out.
# The backward's, from the JAX kernel's own cost model
# (lsmc_pallas.py:298-306): (n + 1) slabs of 4 bytes a path, and
# (5(2d + 1) + 2d + 8) operations a path and date.


def american_bound_ms(contracts: int, rows: int, cols: int, steps: int,
                      every: int) -> tuple[float, str]:
    paths = contracts * rows * cols
    monitors = steps // every
    draws = monitors * (every // 2 + every % 2)
    ops = paths * (PHILOX_KEY_OPS + draws * DRAW_OPS + steps * UNIT_OPS["terminal"] + monitors)
    byte_count = contracts * 32 + paths * monitors * 4
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# With a second state: the n − 1 state rows the regression reads besides (2n
# slabs in all), and per path and date the 3·(kP − (2d + 1)) extra moment
# operations (x^a·v^b, its product with the weight, the add), 3 per extra
# right-hand side, 6 for the policy's three state terms and 4 for v's powers.
def lsmc_bound_ms(contracts: int, rows: int, cols: int, monitors: int,
                  degree: int = LSMC_DEGREE, two_state: bool = False) -> tuple[float, str]:
    paths = contracts * rows * cols
    per_date = 5 * (2 * degree + 1) + 2 * degree + 8
    slabs = monitors + 1
    if two_state:
        extra_moments = len(american_cuda.moment_layout(degree, True)) - (2 * degree + 1)
        per_date += 3 * extra_moments + 3 * 3 + 6 + 4
        slabs += monitors - 1
    ops = per_date * paths * monitors
    byte_count = slabs * paths * 4
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lsmc_sass_per_path_date(library: object, two_state: bool, resident: bool,
                            degree: int = LSMC_DEGREE) -> tuple[float, str]:
    """SASS instructions of a backward kernel's 16-path block per path,
    counted from ``cuobjdump -sass``: a thread's 16 paths of a tile are one
    unrolled block between two barriers (the wait for β and the tile fold's
    first), so the longest BAR-free stretch of the kernel over 16. The
    block alone: the tile fold's stages between barriers, the ticket and the
    solve lie outside it, so a path-date issues more than this count, and
    the share of the cap it gives is a floor on the issue share. The
    stretch may hold the seed's and the policy dates' variants both."""
    piece = f"backward_kernelILi{degree}ELb{int(two_state)}ELb{int(resident)}E"
    text = cuobjdump_sass(library)
    block = next(b for b in text.split("Function : ")[1:] if piece in b.split()[0])
    ops = [op.strip() for _, op in re.findall(SASS_LINE, block)]
    longest, run = 0, 0
    for op in ops:
        if "BAR.SYNC" in op or op.startswith("BAR"):
            longest, run = max(longest, run), 0
        else:
            run += 1
    longest = max(longest, run)
    return longest / american_cuda.PER_THREAD, f"{len(ops)} in all, {longest} between barriers"


def philox_products(body: list[tuple[int, str]]) -> tuple[int, int]:
    """``(unskipped, skipped)``: the high-half products (PHILOX_MULTIPLY) of a
    loop body outside and inside its skipped regions. A loop that walks
    whole Philox calls has 20 a call unskipped and none skipped; a rolled
    loop draws behind a parity test, which skips its call."""
    skipped = set()
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        if jump and op.startswith("@") and addr < int(jump.group(1), 16) <= body[-1][0]:
            skipped.update(a for a, _ in body if addr < a < int(jump.group(1), 16))
    hits = [a for a, op in body if re.search(PHILOX_MULTIPLY, op)]
    return sum(a not in skipped for a in hits), sum(a in skipped for a in hits)


def walks(body: list[tuple[int, str]]) -> bool:
    unskipped, skipped = philox_products(body)
    return unskipped >= 16 and not skipped


def walk_loop(loops: list[list[tuple[int, str]]]) -> list[tuple[int, str]]:
    """The loop that walks whole Philox calls (``walks``; the longest)."""
    return max((b for b in loops if walks(b)), key=len)


def walk_or_longest(loops: list[list[tuple[int, str]]]) -> list[tuple[int, str]]:
    """``walk_loop`` where a loop walks whole calls, else the longest loop."""
    return walk_loop(loops) if any(walks(b) for b in loops) else max(loops, key=len)


def monitor_sass_count(text: str, piece: str, draws_per_step: float = 1, rare: bool = False,
                       **rolled: bool) -> tuple[float, str]:
    """SASS instructions one path-step of a monitor kernel executes at
    ``every = 1``. A kernel with a loop that walks whole Philox calls for
    that grid (``walk_loop``; ``draws_per_step`` draws a step) counts it by
    ``loop_weights``' rule (``rare``: a skipped region that neither draws nor
    ends by jumping over an else arm never runs on these inputs, the Merton
    count's rare branch); one whose date and step loops are rolled by
    ``american_sass_count``'s (``rolled`` its options)."""
    block = next(b for b in text.split("Function : ")[1:] if piece in b.split()[0])
    if not any(walks(b) for b in loop_bodies(block)):
        return american_sass_count(text, piece, **rolled)
    weights, steps, found = loop_weights(block, piece, pick_loop=walk_loop,
                                         single_step=lambda group: rare,
                                         draws_per_step=draws_per_step)
    return sum(w for _, _, w in weights) / steps, found


def loop_bodies(block: str) -> list[list[tuple[int, str]]]:
    """Every loop of one function's ``cuobjdump -sass`` text: the
    instructions from a backward branch's target to the branch."""
    ins = [(int(a, 16), op.strip()) for a, op in re.findall(SASS_LINE, block)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (addr, op) in enumerate(ins):
        back = re.search(SASS_BRANCH, op)
        if back and int(back.group(1), 16) < addr and int(back.group(1), 16) in at:
            loops.append(ins[at[int(back.group(1), 16)]:i + 1])
    return loops


def american_sass_per_step(library: object) -> tuple[float, str]:
    """SASS instructions one path-step of the GBM monitor kernel executes at
    ``every = 1`` (``monitor_sass_count``): its walk over whole Philox calls,
    two dates a call; in a build without one, the rolled rule: the monitor
    loop less the pair-step loop inside it (idle at ``every = 1``)."""
    return monitor_sass_count(cuobjdump_sass(library), "american_gbm_kernel", skip_inner=True)


def american_sass_count(text: str, piece: str, *, skip_inner: bool = True,
                        halve_philox: bool = True) -> tuple[float, str]:
    """The rolled rule on the text of ``cuobjdump -sass`` for the kernel
    whose mangled name holds ``piece``: the monitor loop (the kernel's
    longest loop) less the loops inside it where ``skip_inner``, less a slow
    path holding a CALL, less half the Philox block (the innermost skipped
    region with >= 16 IMAD.WIDE.U32, run every other draw; the single step
    that holds it runs every step); ``skip_inner=False`` keeps the loops
    inside the monitor loop (a one-step loop that runs once a date at
    ``every = 1``); ``halve_philox=False`` for a kernel that calls Philox
    every step (its skipped region is then the step loop's entry guard,
    which runs)."""
    block = next(b for b in text.split("Function : ")[1:] if piece in b.split()[0])
    loops = loop_bodies(block)
    if not loops:
        raise AssertionError(f"no loop found in the SASS of {piece}")
    outer = max(loops, key=len)
    lo, hi = outer[0][0], outer[-1][0]
    inner = [b for b in loops if skip_inner and b is not outer and lo <= b[0][0]
             and b[-1][0] <= hi]
    skip = {a for b in inner for a, _ in b}
    body = [(a, op) for a, op in outer if a not in skip]
    regions = []  # (start, end) of each skipped region of the body
    for addr, op in body:
        jump = re.search(SASS_BRANCH, op)
        if jump and op.startswith("@") and addr < int(jump.group(1), 16) <= hi:
            regions.append((addr, int(jump.group(1), 16)))

    def ops(start: int, end: int) -> list[str]:
        return [o for a, o in body if start < a < end]

    draws = [r for r in regions if sum("IMAD.WIDE.U32" in o for o in ops(*r)) >= 16]
    philox = sum(len(ops(*r)) for r in draws
                 if not any(q != r and r[0] <= q[0] and q[1] <= r[1] for q in draws))
    calls = sum(len(ops(*r)) for r in regions
                if r not in draws and any("CALL" in o for o in ops(*r)))
    if not halve_philox:
        philox = 0
    per_step = len(body) - calls - philox / 2
    return per_step, f"{len(outer)}-{len(outer) - len(body)}-{calls}-{philox}/2={per_step:g}"


def american_sass_split(gbm: object, dynamics: object) -> None:
    """The ``sass-split`` lines of the GBM, Heston, Merton and 3-asset basket
    monitor kernels' walk loops at ``every = 1`` (one draw a step; Merton
    three words, its count's rare branch subtracted; the basket two)."""
    for kernel, library, piece, draws in (
            ("american_gbm", gbm, "american_gbm_kernel", 1),
            ("american_heston", dynamics, "american_heston_kernel", 1),
            ("american_merton", dynamics, "american_merton_kernel", MERTON_DRAWS_PER_STEP),
            ("american_basket3_arithmetic", dynamics, "american_basket_kernelILi3ELb0E", 2),
            ("american_basket3_geometric", dynamics, "american_basket_kernelILi3ELb1E", 2)):
        try:  # a measurement only: a toolkit without nvdisasm or line info prints why
            sass = cuobjdump_sass(library)
            block = next(b for b in sass.split("Function : ")[1:] if piece in b.split()[0])
            if not any(walks(b) for b in loop_bodies(block)):
                raise AssertionError(f"{piece} has no loop over whole Philox calls")
            split = sass_split(sass, nvdisasm_text(library), piece, draws_per_step=draws,
                               pick_loop=walk_loop, single_step=kernel == "american_merton")
        except (AssertionError, OSError, StopIteration, subprocess.CalledProcessError) as err:
            split = {"error": repr(err)[:300]}
        phase("sass-split", kernel=kernel, parts="per path-step", **split)


def phase_kernel_american(device: torch.device, sass: tuple[float, str],
                          max_sm_hz: float) -> dict[str, dict[str, object]]:
    """The monitor-row kernel against its twin on the same Philox stream;
    with ``every`` even its last row against the TERMINAL kernel; then its
    time at the training chunk beside the twin's, the bound and the SASS."""
    worst = {"max_abs_err": 0.0, "max_rel": 0.0}
    for steps, every, half in AMERICAN_CASES:
        params, keys = kernel_inputs(device, AMERICAN_CONTRACTS, steps + every)
        kw = dict(timesteps=steps, rows=ROWS, cols=COLS, exercise_every=every,
                  antithetic_half=half)
        got = american_cuda.simulate_american_rows_cuda(params, keys, **kw)
        want = american_cuda.simulate_american_rows_cuda_plain(params, keys, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"american_gbm: non-finite rows at {kw}")
        err = (got - want).abs()
        rel = float((err / want.abs()).max())
        if rel > KERNEL_RTOL:
            raise AssertionError(f"american_gbm: rows off the twin by {rel:.3e} at {kw}")
        worst.update(max_abs_err=max(worst["max_abs_err"], float(err.max())),
                     max_rel=max(worst["max_rel"], rel))
        extra = {}
        if every % 2 == 0:
            terminal = gbm_cuda.simulate_underlier_rows_cuda(
                params, keys, timesteps=steps, rows=ROWS, cols=COLS,
                scheme=PathScheme.LOG_EULER, payoff=PayoffKind.TERMINAL, antithetic_half=half)
            last = got[:, -1]
            if not torch.equal(last, terminal):  # the same pair step on the same words
                off = float(((last - terminal).abs() / terminal.abs()).max())
                raise AssertionError(f"american_gbm: last row not TERMINAL's at {kw} "
                                     f"({int((last != terminal).sum())} paths, {off:.3e})")
            extra = dict(last_row_equals_terminal_kernel=True)
        phase("kernel-american", case=f"T{steps}_every{every}" + ("_anti" if half else ""),
              shape=f"{AMERICAN_CONTRACTS}x{steps // every}x{ROWS}x{COLS}",
              max_rel_diff=f"{rel:.3e}", max_abs_err=f"{float(err.max()):.3e}",
              rtol=KERNEL_RTOL, **extra)
        del got, want, err
    params, keys = kernel_inputs(device, CHUNK, 1)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, exercise_every=1)
    ms = cuda_ms(lambda: american_cuda.simulate_american_rows_cuda(params, keys, **kw))
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: american_cuda.simulate_american_rows_cuda_plain(params, keys, **kw),
                       iters=1, warmup=0)
    torch.cuda.empty_cache()
    bound, bound_by = american_bound_ms(CHUNK, ROWS, COLS, STEPS, 1)
    per_step, found = sass
    path_steps = CHUNK * ROWS * COLS * STEPS
    cap = LANES_PER_CLOCK * max_sm_hz / per_step
    bound4, by4 = american_bound_ms(CHUNK, ROWS, COLS, STEPS, 4)
    ms4 = cuda_ms(lambda: american_cuda.simulate_american_rows_cuda(
        params, keys, timesteps=STEPS, rows=ROWS, cols=COLS, exercise_every=4))
    torch.cuda.empty_cache()
    phase("kernel-american-time", kernel="american_gbm", shape=f"{CHUNK}x{ROWS}x{COLS}x{STEPS}",
          every=1, kernel_ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.3f}",
          bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
          output_gb=round(CHUNK * ROWS * COLS * STEPS * 4 / 1e9, 3),
          sass_per_path_step=round(per_step, 3), sass_loop=found,
          **cap_share(path_steps / ms * 1e3, cap),
          every4_kernel_ms=f"{ms4:.3f}", every4_bound_ms=f"{bound4:.3f}", every4_bound_by=by4)
    return {"american_gbm": dict(worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=bound_by)}


def lsmc_inputs(device: torch.device, contracts: int, rows: int, cols: int,
                seed: int) -> tuple[torch.Tensor, ...]:
    """``(price_rows, strike, disc, df)``: the monitor kernel's rows at
    ``every = 1`` for seeded contracts."""
    params, keys = kernel_inputs(device, contracts, seed)
    price_rows = american_cuda.simulate_american_rows_cuda(
        params, keys, timesteps=STEPS, rows=rows, cols=cols, exercise_every=1)
    disc, df = american_cuda.monitor_discounts(params, timesteps=STEPS, exercise_every=1)
    return price_rows, params[:, 1].contiguous(), disc, df


def launched_by(fn) -> tuple[object, dict[str, int]]:
    """``fn()`` and the launch counts it moved."""
    before = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    out = fn()
    return out, {b: n - before[b] for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items()
                 if n != before[b]}


def backward_against_twin(name: str, price_rows: torch.Tensor, kw: dict[str, object]) -> int:
    """The backward on its own route and on the other, each bit-equal to the
    twin (u and so every exercise date); returns the twin's flips (0)."""
    want = american_cuda.lsmc_backward_cuda_plain(price_rows, **kw)
    got, launched = launched_by(lambda: american_cuda.lsmc_backward_cuda(price_rows, **kw))
    resident = name.endswith("_streamed")  # the other route's
    flips = int((got != want).sum())
    if launched != {name: 1} or flips:
        raise AssertionError(f"{name}: launches {launched}, {flips} paths off the twin")
    grid, slots = american_cuda.lsmc_plan(kw["basis_degree"], kw.get("extra_rows") is not None,
                                          True, price_rows.device.index or 0)
    if american_cuda.lsmc_route(price_rows.shape[2] * price_rows.shape[3],
                                grid * slots) != "resident":
        return flips  # past the resident grid's capacity: one route only
    forced = american_cuda._lsmc_launch(price_rows, resident=resident, **kw)
    if not torch.equal(forced, want):
        raise AssertionError(f"{name}: the {'resident' if resident else 'streamed'} route is "
                             f"off the twin")
    return flips


def time_backward(name: str, price_rows: torch.Tensor, kw: dict[str, object],
                  sass: dict[str, tuple[float, str]], max_sm_hz: float,
                  **extra: object) -> dict:
    """``name``'s time at ``price_rows``' shape beside the twin's, both
    bounds and their shares, and the schedule's bytes; at that shape (the
    main path's, for the resident route) the kernel's output and a repeated
    launch's are bit-equal to the twin's, and ``max_abs_err`` is theirs."""
    contracts, monitors, rows, cols = price_rows.shape
    two = kw.get("extra_rows") is not None
    ms = cuda_ms(lambda: american_cuda.lsmc_backward_cuda(price_rows, **kw))
    got = american_cuda.lsmc_backward_cuda(price_rows, **kw)
    again = american_cuda.lsmc_backward_cuda(price_rows, **kw)
    twin: list[torch.Tensor] = []
    plain_ms = cuda_ms(lambda: twin.append(american_cuda.lsmc_backward_cuda_plain(price_rows,
                                                                                 **kw)),
                       iters=1, warmup=0)
    want = twin[-1]
    err = max(float((got - want).abs().max()), float((again - want).abs().max()))
    flips = int((got != want).sum()) + int((again != want).sum())
    if flips or not (torch.equal(got, want) and torch.equal(again, want)):
        raise AssertionError(f"{name}: at {contracts}x{rows}x{cols}x{monitors} {flips} paths of "
                             f"two launches off the twin (max abs err {err:.3e})")
    del got, again, twin, want
    torch.cuda.empty_cache()
    bound, bound_by = lsmc_bound_ms(contracts, rows, cols, monitors, two_state=two)
    paths = contracts * rows * cols
    resident = not name.endswith("_streamed")
    slabs = ((2 * monitors if two else monitors + 1) if resident
             else (4 * (monitors - 1) + 3) * (2 if two else 1))
    per_date, found = sass[name]
    cap = LANES_PER_CLOCK * max_sm_hz / per_date
    grid, slots = american_cuda.lsmc_plan(LSMC_DEGREE, two, True, price_rows.device.index or 0)
    phase("kernel-lsmc-time", kernel=name, shape=f"{contracts}x{rows}x{cols}x{monitors}",
          degree=LSMC_DEGREE, kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
          bound_ms=f"{bound:.3f}", bound_by=bound_by, share_of_bound=f"{bound / ms:.4f}",
          byte_bound_ms=f"{slabs * paths * 4 / HBM_BYTES_PER_S * 1e3:.3f}",
          schedule_gb=round(slabs * paths * 4 / 1e9, 3),
          schedule_bytes_per_s=f"{slabs * paths * 4 / ms * 1e3:.4e}",
          twin_bit_equal_at_shape=True, repeat_bit_equal=True, max_abs_err=err,
          block_sass_per_path_date=round(per_date, 3), sass_block=found,
          **cap_share(paths * monitors / ms * 1e3, cap, "share_of_block_instruction_cap"),
          resident_grid=f"{grid}x{slots} tiles", launches_per_backward=1, **extra)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, max_abs_err=err)


def phase_kernel_lsmc(device: torch.device, sass: dict[str, tuple[float, str]],
                      max_sm_hz: float) -> dict[str, dict[str, object]]:
    """The single-state backward against its twin on the GBM monitor rows,
    put and call, at the shapes of both TPU kernels: ``lsmc_route`` picks
    the resident kernel at 2^20 paths a contract and the streamed one at
    2^22, each bit-equal to the twin (0 flips) and so is the other route
    where it fits; against the torch estimator the mean within 2e-3 and at
    most 2% flipped. Then each timed at its shape (the resident at the
    training chunk) beside the twin, the sweep/solve pair it replaced, both
    bounds and the 16-path block's SASS against the instruction cap; at
    each timed shape two launches bit-equal to the twin."""
    record: dict[str, dict[str, object]] = {}
    for name, (rows, cols) in LSMC_SHAPES.items():
        price_rows, strike, disc, df = lsmc_inputs(device, AMERICAN_CONTRACTS, rows, cols, 21)
        paths = AMERICAN_CONTRACTS * rows * cols
        for put in (True, False):
            kw = dict(strike=strike, disc=disc, df=df, put=put, basis_degree=LSMC_DEGREE)
            flips = backward_against_twin(name, price_rows, kw)
            got = american_cuda.lsmc_backward_cuda(price_rows, **kw)
            cf_got = (strike[:, None, None] - got) * df[:, None, None]
            mean_got = float(cf_got.double().mean())
            cf_torch = american.lsmc_backward(price_rows, strike=strike, disc=disc,
                                              dtype=torch.float32, put=put,
                                              basis_degree=LSMC_DEGREE)
            u_torch = strike[:, None, None] - cf_torch / df[:, None, None]
            torch_flips = float((got != u_torch).float().mean())
            mean_torch = float(cf_torch.double().mean())
            torch_rel = abs(mean_got - mean_torch) / abs(mean_torch)
            if torch_flips > TORCH_FLIP_SHARE or torch_rel > TORCH_MEAN_RTOL:
                raise AssertionError(f"{name} put={put}: vs the torch estimator {torch_flips:.4f} "
                                     f"flipped, mean off {torch_rel:.2e}")
            phase("kernel-lsmc", kernel=name, side="put" if put else "call",
                  shape=f"{AMERICAN_CONTRACTS}x{rows}x{cols}x{STEPS}", degree=LSMC_DEGREE,
                  route="streamed" if name.endswith("_streamed") else "resident",
                  twin_flips=flips, twin_bit_equal=True,
                  both_routes_bit_equal=rows * cols <= 1 << 20,
                  mean_cashflow=round(mean_got, 6),
                  torch_estimator_flip_share=f"{torch_flips:.5f}",
                  torch_estimator_mean_rel=f"{torch_rel:.3e}", paths=paths)
            del got, cf_got, cf_torch, u_torch
        kw = dict(strike=strike, disc=disc, df=df, put=True, basis_degree=LSMC_DEGREE)
        if name == "lsmc_backward":  # timed at the training chunk
            del price_rows
            torch.cuda.empty_cache()
            price_rows, strike, disc, df = lsmc_inputs(device, CHUNK, rows, cols, 22)
            kw = dict(strike=strike, disc=disc, df=df, put=True, basis_degree=LSMC_DEGREE)
        record[name] = time_backward(name, price_rows, kw, sass, max_sm_hz,
                                     sweep_solve_pair_ms=SWEEP_SOLVE_MS[name])
        del price_rows
        torch.cuda.empty_cache()
    return record


AMERICAN_ORACLES = [  # (label, contract, option, oracle) at 16 monitor dates
    ("put", dict(spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25),
     "put", "tree"),
    ("dividend call", dict(spot=100.0, strike=95.0, maturity=2.0, rate=0.02, div_yield=0.08,
                           vol=0.25), "call", "tree"),
    ("r=0 put", dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.0, div_yield=0.0,
                     vol=0.25), "put", "black"),
    ("q=0 call", dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.05, div_yield=0.0,
                      vol=0.25), "call", "black"),
]


def phase_oracle_american(device: torch.device) -> None:
    """``lsmc_price`` on the card (the monitor kernel and the backward,
    1,048,576 paths, 16 dates) within max(4 SE, 0.5% of the price) of the
    Bermudan tree, or of Black where early exercise is worth nothing
    (tests/test_american.py's gates)."""
    for i, (label, c, option, oracle) in enumerate(AMERICAN_ORACLES):
        before = gbm_cuda.LAUNCHES_BY_BRANCH["lsmc_backward"]
        got = american.lsmc_price(rng.prng_key(40 + i, device), BlackScholesContract(**c),
                                  timesteps=STEPS, paths=ROWS * COLS,
                                  option=american.OptionSide(option),
                                  implementation=SimImplementation.CUDA, device=device)
        if gbm_cuda.LAUNCHES_BY_BRANCH["lsmc_backward"] != before + 1:
            raise AssertionError(f"oracle-american {label}: the CUDA backward did not run")
        if oracle == "tree":
            want = american.bermudan_tree_price(**c, exercise_dates=STEPS, option=option)
        else:
            black = analytic.black_scholes_price(*c.values())
            want = float(black.put if option == "put" else black.call)
        tol = max(4.0 * got.std_error, 0.005 * want)
        if not abs(got.price - want) <= tol:
            raise AssertionError(f"oracle-american {label}: {got.price:.5f} ± "
                                 f"{got.std_error:.1e} vs {oracle} {want:.5f}")
        phase("oracle-american", contract=label, option=option, oracle=oracle,
              paths=ROWS * COLS, dates=STEPS, price=round(got.price, 5),
              se=f"{got.std_error:.2e}", want=round(want, 5), tol=f"{tol:.4f}",
              european=round(got.european, 5), premium=round(got.price - got.european, 5),
              cv_price=round(got.cv_price, 5), cv_se=f"{got.cv_std_error:.2e}")


def american_config(payoff: PayoffKind = PayoffKind.AMERICAN_PUT, *, rows: int = ROWS,
                    **knobs: object) -> GbmCVNNPricerConfig:
    """The American pricer: the production head, spot and strike 80–120,
    vol 15–45%, normalization none, the CUDA backward unless ``knobs`` say
    otherwise."""
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=rows, mc_seed=7,
        implementation="cuda", payoff=payoff.value, normalization="none",
        **{"lsmc_fused_backward": True, **knobs},
    ).expect("american sim")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds_for(payoff), cvnn=production_cvnn(),
                               normalize_inputs=True)


def phase_train_american(device: torch.device) -> GbmCVNNPricer:
    """3 steps of the American put pricer at the production batch: one
    monitor-kernel launch and one CUDA backward per chunk, the backward's
    version recorded; the step's peak device memory."""
    pricer = GbmCVNNPricer.create(american_config(), device=device).expect("american")
    before = {k: gbm_cuda.LAUNCHES_BY_BRANCH[k] for k in ("american_gbm", "lsmc_backward")}
    torch.cuda.reset_peak_memory_stats(device)
    losses, seconds = train_steps(pricer, 3)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launched = {k: gbm_cuda.LAUNCHES_BY_BRANCH[k] - v for k, v in before.items()}
    snap = pricer.snapshot()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"american: non-finite training losses {losses}")
    if set(launched.values()) != {3 * BATCH // CHUNK}:
        raise AssertionError(f"american: launches {launched} in 3 steps")
    want = american_cuda.LSMC_BACKWARD_VERSIONS["cuda"]
    stream = gbm_cuda.CUDA_STREAM_VERSIONS["american_gbm"]
    if (snap.sim.implementation.value, snap.lsmc_backward_version,
            snap.cuda_stream_version) != ("cuda", want, stream):
        raise AssertionError(f"american: engine {snap.sim.implementation.value}, backward "
                             f"v{snap.lsmc_backward_version}, stream v{snap.cuda_stream_version}")
    phase("train-american", payoff=snap.sim.payoff.value, engine="cuda",
          stream=f"american_gbm_v{stream}", lsmc_backward_version=snap.lsmc_backward_version,
          normalization=snap.sim.normalization.value, losses=losses.tolist(),
          launches=launched, step_seconds=[round(s, 4) for s in seconds],
          median_step_s=f"{statistics.median(seconds):.4f}", peak_memory_gb=round(peak_gb, 3),
          monitor_rows_gb_per_chunk=round(CHUNK * STEPS * ROWS * COLS * 4 / 1e9, 3),
          paths_per_contract=ROWS * COLS, batch=BATCH, chunk=CHUNK)
    return pricer


# Phase 21's pricers: (label, payoff, knobs, batch rows, engine, backward,
# the kernel launch counts that must move)
AMERICAN_FAMILIES = [
    ("call", PayoffKind.AMERICAN_CALL, {}, ROWS, "cuda", 3, ("american_gbm", "lsmc_backward")),
    ("cross-fit", PayoffKind.AMERICAN_PUT, dict(lsmc_fused_backward=False, lsmc_cross_fit=True),
     ROWS, "cuda", 0, ("american_gbm",)),
    ("every 4", PayoffKind.AMERICAN_PUT, dict(lsmc_exercise_every=4), ROWS, "cuda", 3,
     ("american_gbm", "lsmc_backward")),
    ("antithetic", PayoffKind.AMERICAN_PUT, dict(antithetic=True), ROWS, "cuda", 3,
     ("american_gbm", "lsmc_backward")),
    ("degree 3", PayoffKind.AMERICAN_PUT, dict(lsmc_basis_degree=3), ROWS, "cuda", 3,
     ("american_gbm", "lsmc_backward")),
    ("curved term", PayoffKind.AMERICAN_PUT, dict(lsmc_fused_backward=False, term=term_of(STEPS)),
     ROWS, "xla", 0, ()),
    ("4,194,304 paths", PayoffKind.AMERICAN_PUT, {}, 8192, "cuda", 3,
     ("american_gbm", "lsmc_backward_streamed")),
]
AMERICAN_CURVE_CONTRACT = dict(spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.01,
                               vol=0.25)


def american_curve_gate(device: torch.device) -> dict[str, object]:
    """The threefry engine under ``term_of`` curves for one put over
    1,048,576 paths against ``bermudan_grid_price`` on the same curves,
    within max(4 SE, 1%)."""
    c = AMERICAN_CURVE_CONTRACT
    term = term_of(STEPS)
    contracts = torch.tensor([list(c.values())], dtype=torch.float32, device=device)
    keys = rng.fold_in(rng.prng_key(61, device), torch.arange(1, device=device))
    u = american.simulate_american_underlier_rows(
        keys, contracts, timesteps=STEPS, rows=ROWS, cols=COLS, dtype=torch.float32,
        option=american.OptionSide.PUT, term=term)
    df = math.exp(-c["rate"] * term.effective_factors(STEPS)[1] * c["maturity"])
    cf = (c["strike"] - u.double().reshape(-1)) * df
    mean, se = float(cf.mean()), float(cf.std() / math.sqrt(cf.numel()))
    want = american.bermudan_grid_price(**c, timesteps=STEPS, option="put",
                                        vol_shape=term.vol_shape, rate_shape=term.rate_shape)
    tol = max(4.0 * se, 0.01 * want)
    if not abs(mean - want) <= tol:
        raise AssertionError(f"curved American put {mean:.5f} ± {se:.1e} vs grid {want:.5f}")
    return dict(mc=round(mean, 5), se=f"{se:.2e}", grid=round(want, 5), tol=f"{tol:.4f}")


def phase_families_american(device: torch.device) -> None:
    """One step at batch 64 (batch 4 for the 4,194,304-path contract) per
    pricer of ``AMERICAN_FAMILIES``: the engine and backward recorded, the
    kernels launched once, a finite loss, the learned side finite and the
    other NaN; the curved one gated against the grid oracle."""
    for label, payoff, knobs, rows, engine, backward, groups in AMERICAN_FAMILIES:
        pricer = GbmCVNNPricer.create(american_config(payoff, rows=rows, **knobs),
                                      device=device).expect(label)
        batch = 4 if rows > ROWS else PAYOFF_BATCH
        before = {g: gbm_cuda.LAUNCHES_BY_BRANCH[g] for g in groups}
        losses, seconds = train_steps(pricer, 1, batch=batch, chunk=batch)
        launched = {g: gbm_cuda.LAUNCHES_BY_BRANCH[g] - v for g, v in before.items()}
        snap = pricer.snapshot()
        if (snap.sim.implementation.value, snap.lsmc_backward_version) != (engine, backward):
            raise AssertionError(f"american {label}: engine {snap.sim.implementation.value}, "
                                 f"backward v{snap.lsmc_backward_version}")
        if any(n != 1 for n in launched.values()) or not np.all(np.isfinite(losses)):
            raise AssertionError(f"american {label}: launches {launched}, loss {losses}")
        pred = check_prices(pricer, held_out(payoff, 8), device)
        extra = american_curve_gate(device) if engine == "xla" else {}
        phase("families-american", pricer=label, payoff=payoff.value, engine=engine,
              stream_version=snap.cuda_stream_version, lsmc_backward_version=backward,
              launches=launched, paths_per_contract=rows * COLS, batch=batch,
              loss=float(losses[0]), step_s=round(seconds[0], 4),
              prices=np.round(pred.call if payoff == PayoffKind.AMERICAN_CALL else pred.put,
                              5)[:3].tolist(), **extra)
        del pricer
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 22-27. American (LSMC) pricing under Heston, Merton and baskets
# --------------------------------------------------------------------------

DYNAMICS_AMERICAN_SOURCE = "spectralmc_tpu_torch/csrc/american_dynamics.cu"
DYNAMICS_AMERICAN_REPLACES = {
    "american_heston": "spectralmc_tpu/ops/gbm_pallas.py:2260",
    "american_merton": "spectralmc_tpu/ops/gbm_pallas.py:3454",
    "american_basket": "spectralmc_tpu/ops/gbm_pallas.py:2873",
}
# kernel case -> (family bounds, basket (assets, combine) or None); each
# runs DYNAMICS_CASES: (timesteps, every, antithetic half)
DYNAMICS_KERNELS = {
    "heston": ("heston", None),
    "merton": ("merton", None),
    "basket3_arithmetic": ("basket", (3, "arithmetic")),
    "basket3_geometric": ("basket", (3, "geometric")),
    "basket1_arithmetic": ("basket", (1, "arithmetic")),
}
DYNAMICS_CASES = [(STEPS, 1, None), (STEPS, 1, ROWS // 2), (STEPS, 4, None),
                  (15, 5, ROWS // 2), (15, 1, None)]
VAR_ATOL = 1e-6  # Heston's max(v, 0) rows: the variance reaches 0
# The monitor kernels' op model per path: per step the European kernel's
# (Heston: a draw and HESTON_STEP_OPS; Merton: MERTON_STEP_OPS and the
# log-price update; the basket: basket_step_ops), and per monitor date its
# stores' own work (Heston: exp and max; Merton: exp; the basket: the value,
# and for the arithmetic combine a log, the log-geometric chain (A
# multiply-adds) and a subtraction). Bytes: the contract, the key (and the
# Merton level table) in, the monitor rows out.


def dynamics_bound_ms(case: str, contracts: int, steps: int,
                      every: int = 1) -> tuple[float, str]:
    family, basket = DYNAMICS_KERNELS[case]
    paths = contracts * ROWS * COLS
    monitors = steps // every
    byte_count = contracts * (4 * len(FAMILY_CONTRACT[family].model_fields) + 8)
    if family == "heston":
        ops = paths * (PHILOX_KEY_OPS + steps * (DRAW_OPS + HESTON_STEP_OPS) + 2 * monitors)
        byte_count += 2 * paths * monitors * 4
    elif family == "merton":
        ops = paths * (PHILOX_KEY_OPS + steps * (MERTON_STEP_OPS + UNIT_OPS["terminal"] + 1)
                       + monitors)
        byte_count += contracts * 64 + paths * monitors * 4
    else:
        assets, combine = basket
        geometric = combine == "geometric"
        value = assets + 1 if geometric else 2 * assets
        per_date = value if geometric else value + assets + 2
        ops = paths * (PHILOX_KEY_OPS + steps * basket_step_ops(assets, "terminal", geometric)
                       + monitors * per_date)
        byte_count += (1 if geometric else 2) * paths * monitors * 4
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dynamics_spec(case: str) -> object | None:
    basket = DYNAMICS_KERNELS[case][1]
    return None if basket is None else spec_of(*basket)


def dynamics_rows(case: str, params: torch.Tensor, keys: torch.Tensor, *, plain: bool = False,
                  **kw: object) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(price rows, second state or None)`` of a case's monitor kernel, or
    of its plain twin."""
    family = DYNAMICS_KERNELS[case][0]
    if family == "basket":
        fn = (american_cuda.simulate_basket_american_rows_cuda_plain if plain
              else american_cuda.simulate_basket_american_rows_cuda)
        return fn(params, keys, spec=dynamics_spec(case), **kw)
    if family == "heston":
        fn = (american_cuda.simulate_heston_american_rows_cuda_plain if plain
              else american_cuda.simulate_heston_american_rows_cuda)
        return fn(params, keys, **kw)
    fn = (american_cuda.simulate_merton_american_rows_cuda_plain if plain
          else american_cuda.simulate_merton_american_rows_cuda)
    return fn(params, keys, **kw), None


def dynamics_terminal(case: str, params: torch.Tensor, keys: torch.Tensor,
                      **kw: object) -> torch.Tensor:
    """The European kernel's TERMINAL value on the same stream."""
    family = DYNAMICS_KERNELS[case][0]
    kw = dict(kw, payoff=PayoffKind.TERMINAL)
    if family == "basket":
        return basket_cuda.simulate_basket_rows_cuda(params, keys, spec=dynamics_spec(case), **kw)
    return FAMILY_FNS[family][0](params, keys, **kw)


def compare_dynamics(case: str, got: tuple, want: tuple,
                     params: torch.Tensor) -> dict[str, float]:
    """A monitor kernel's rows against its twin's; raises past the gates.
    Price rows rtol 2e-5; Heston's variance rows atol 1e-6 + rtol 2e-5; a
    Heston path that misses either (at most HESTON_SHARE of the case's
    paths) stays within HESTON_CAP_RTOL of the price and of the variance
    measured against its long-run level θ; the arithmetic basket's log
    dispersion within 2e-5 of |ln B|, the level it cancels from."""
    (price, extra), (price_w, extra_w) = got, want
    if not bool(torch.isfinite(price).all()):
        raise AssertionError(f"{case}: non-finite monitor rows")
    err = (price - price_w).abs()
    missed = (err > KERNEL_RTOL * price_w.abs()).any(dim=1)  # per path, over its dates
    found = {"max_rel": float((err / price_w.abs()).max()), "max_abs_err": float(err.max())}
    if not bool((err <= HESTON_CAP_RTOL * price_w.abs()).all()):
        raise AssertionError(f"{case}: price rows off the twin by {found['max_rel']:.3e}")
    if case == "heston":
        var_err = (extra - extra_w).abs()
        missed |= (var_err > VAR_ATOL + KERNEL_RTOL * extra_w.abs()).any(dim=1)
        theta = params[:, 7, None, None, None]
        var_scaled = var_err / torch.maximum(extra_w, theta)
        found.update(var_max_abs_err=float(var_err.max()), var_max_scaled=float(var_scaled.max()),
                     var_rows_bit_equal=bool(torch.equal(extra, extra_w)),
                     price_rows_bit_equal=bool(torch.equal(price, price_w)))
        if not bool((var_scaled <= HESTON_CAP_RTOL).all()):
            raise AssertionError(f"heston: variance rows off by {found['var_max_scaled']:.3e}·θ")
    elif extra_w is not None:
        disp_err = (extra - extra_w).abs()
        scaled = float((disp_err / torch.log(price_w).abs()).max())
        found.update(disp_max_abs_err=float(disp_err.max()), disp_max_scaled=scaled)
        if scaled > KERNEL_RTOL:
            raise AssertionError(f"{case}: dispersion rows off by {scaled:.3e}·|ln B|")
    found["missed_paths"] = int(missed.sum())
    allowed = HESTON_SHARE * missed.numel() if case == "heston" else 0
    if found["missed_paths"] > allowed:
        raise AssertionError(f"{case}: {found['missed_paths']} paths past the tolerances")
    if case != "heston" and found["max_rel"] > KERNEL_RTOL:
        raise AssertionError(f"{case}: price rows off the twin by {found['max_rel']:.3e}")
    return found


def check_american_merton_counts(device: torch.device) -> int:
    """The Merton monitor kernel's jump counts against its twin's, exactly:
    with the Gaussians off (vol = jump_std = 0) and unit jumps, ln S at each
    monitor date less the compensated drift is the count so far. Returns
    the jumps seen."""
    c = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 2.5, 1.0, 0.0],
                      [1.0, 1.0, 2.0, 0.0, 0.0, 0.0, 6.0, 1.0, 0.0]], device=device)
    keys = rng.fold_in(rng.prng_key(4), torch.arange(2)).to(device)
    kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, exercise_every=4, antithetic_half=ROWS // 2)
    dates = torch.arange(1, STEPS // 4 + 1, device=device, dtype=torch.float32) / (STEPS // 4)
    drift = -(c[:, 6] * (math.e - 1.0) * c[:, 2])[:, None] * dates  # [C, dates]
    kernel, twin = (
        torch.round(torch.log(fn(c, keys, **kw)) - drift[:, :, None, None])
        for fn in (american_cuda.simulate_merton_american_rows_cuda,
                   american_cuda.simulate_merton_american_rows_cuda_plain))
    if not torch.equal(kernel, twin):
        raise AssertionError(f"American Merton counts differ at {int((kernel != twin).sum())} "
                             "path-dates")
    return int(kernel[:, -1].sum())


def dynamics_sass_per_step(library: object) -> dict[str, tuple[float, str]]:
    """SASS instructions one path-step of each monitor kernel executes at
    ``every = 1``: the Heston, Merton and basket walks over whole Philox
    calls (``monitor_sass_count``; a Merton step takes three words, its
    count's rare branch subtracted; a 3-asset basket step two draws); a
    build without a walk by the rolled rule (``american_sass_count``: a
    Merton kernel that calls Philox every step keeps its Philox block)."""
    text = cuobjdump_sass(library)
    baskets = {"basket3_arithmetic": "american_basket_kernelILi3ELb0E",
               "basket3_geometric": "american_basket_kernelILi3ELb1E"}
    return {"heston": monitor_sass_count(text, "american_heston_kernel", skip_inner=False),
            "merton": monitor_sass_count(text, "american_merton_kernel",
                                         draws_per_step=MERTON_DRAWS_PER_STEP, rare=True,
                                         skip_inner=False, halve_philox=False),
            **{case: monitor_sass_count(text, piece, draws_per_step=2, skip_inner=False)
               for case, piece in baskets.items()}}


DYNAMICS_TIMED = [  # (case, contracts, record name): the twin timed with a record, and at 32
    ("heston", CHUNK, "american_heston"),
    ("merton", CHUNK, "american_merton"),
    ("basket3_arithmetic", BASKET_TIMED_CONTRACTS, "american_basket"),
    ("basket3_geometric", BASKET_TIMED_CONTRACTS, None),
    # the Merton and basket kernels at the batch-64 steps that launch them
    # (phase 26), the basket at the chunk besides
    ("merton", PAYOFF_BATCH, None),
    *((case, contracts, None) for contracts in (PAYOFF_BATCH, CHUNK)
      for case in ("basket3_arithmetic", "basket3_geometric")),
]


def phase_kernel_american_dynamics(
    device: torch.device, sass: dict[str, tuple[float, str]], max_sm_hz: float
) -> dict[str, dict[str, object]]:
    """Each monitor kernel against its twin on the same Philox words at 4 x
    2048 x 512 over DYNAMICS_CASES (compare_dynamics' gates), its last row
    equal to the European kernel's TERMINAL value bit for bit (each shares
    its European kernel's step); the Merton counts exactly; then each kernel
    timed at 256 x 2048 x 512 x 16 (the basket at 32 contracts) as the main
    path pays for it, beside the twin, the bound and the SASS per path-step."""
    worst: dict[str, dict[str, float]] = {}
    for case, (family, _) in DYNAMICS_KERNELS.items():
        w = worst.setdefault(case, {"max_abs_err": 0.0, "max_rel": 0.0, "missed_paths": 0})
        for steps, every, half in DYNAMICS_CASES:
            params, keys = kernel_inputs(device, AMERICAN_CONTRACTS, steps + every, family)
            kw = dict(timesteps=steps, rows=ROWS, cols=COLS, exercise_every=every,
                      antithetic_half=half)
            got = dynamics_rows(case, params, keys, **kw)
            want = dynamics_rows(case, params, keys, plain=True, **kw)
            torch.cuda.synchronize()
            found = compare_dynamics(case, got, want, params)
            terminal = dynamics_terminal(case, params, keys, timesteps=steps, rows=ROWS,
                                         cols=COLS, antithetic_half=half)
            last = got[0][:, -1]
            off = (last - terminal).abs() > KERNEL_RTOL * terminal.abs()
            if not torch.equal(last, terminal):  # the same step on the same words
                raise AssertionError(f"{case}: last row is not TERMINAL's on "
                                     f"{int((last != terminal).sum())} paths")
            w.update(max_abs_err=max(w["max_abs_err"], found["max_abs_err"]),
                     max_rel=max(w["max_rel"], found["max_rel"]),
                     missed_paths=w["missed_paths"] + found["missed_paths"])
            phase("kernel-american-dynamics", kernel=case,
                  case=f"T{steps}_every{every}" + ("_anti" if half else ""),
                  shape=f"{AMERICAN_CONTRACTS}x{steps // every}x{ROWS}x{COLS}",
                  **{k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in found.items()},
                  last_row_equals_terminal_kernel=bool(torch.equal(last, terminal)),
                  last_row_paths_past_rtol=int(off.sum()), rtol=KERNEL_RTOL)
            del got, want, terminal, last, off
    phase("kernel-american-dynamics-counts",
          merton_jumps_equal_to_the_twins=check_american_merton_counts(device),
          paths=2 * ROWS * COLS, dates=STEPS // 4)
    record = {}
    for case, contracts, name in DYNAMICS_TIMED:
        family = DYNAMICS_KERNELS[case][0]
        params, keys = kernel_inputs(device, contracts, 1, family)
        kw = dict(timesteps=STEPS, rows=ROWS, cols=COLS, exercise_every=1)
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: dynamics_rows(case, params, keys, **kw))
        torch.cuda.empty_cache()
        plain = {}
        if name is not None or contracts == BASKET_TIMED_CONTRACTS:
            plain_ms = cuda_ms(lambda: dynamics_rows(case, params, keys, plain=True, **kw),
                               iters=1, warmup=0)
            plain = dict(plain_ms=f"{plain_ms:.3f}")
            torch.cuda.empty_cache()
        bound, bound_by = dynamics_bound_ms(case, contracts, STEPS)
        per_step, found = sass[case]
        path_steps = contracts * ROWS * COLS * STEPS
        cap = LANES_PER_CLOCK * max_sm_hz / per_step
        outputs = 2 if case in ("heston", "basket3_arithmetic") else 1
        phase("kernel-american-dynamics-time", kernel=case,
              shape=f"{contracts}x{ROWS}x{COLS}x{STEPS}", every=1, kernel_ms=f"{ms:.3f}",
              **plain, bound_ms=f"{bound:.3f}", bound_by=bound_by,
              share_of_bound=f"{bound / ms:.4f}",
              output_gb=round(outputs * path_steps * 4 / 1e9, 3),
              sass_per_path_step=round(per_step, 3), sass_loop=found,
              kernel_path_steps_per_s=f"{path_steps / ms * 1e3:.4e}",
              **cap_share(path_steps / ms * 1e3, cap))
        if name is not None:
            w = worst[case]
            if case == "basket3_arithmetic":  # the record's error covers every basket case
                for other in ("basket3_geometric", "basket1_arithmetic"):
                    w = {k: max(w[k], worst[other][k]) for k in ("max_abs_err", "max_rel")}
            record[name] = dict(max_abs_err=w["max_abs_err"], ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=bound_by)
    return record


def estimator_card_vs_cpu(device: torch.device) -> None:
    """The torch estimator (backward 0, which cross-fit still runs on the
    card) on Heston's two state rows at 2 contracts x 64 x 512: the card
    against its own run on the CPU, at most 2% of paths flipped and the mean
    cashflow within 2e-3."""
    params, keys = kernel_inputs(device, 2, 24, "heston")
    price_rows, var_rows = american_cuda.simulate_heston_american_rows_cuda(
        params, keys, timesteps=STEPS, rows=64, cols=COLS, exercise_every=1)
    est = dict(timesteps=STEPS, exercise_every=1, option=american.OptionSide.PUT,
               basis_degree=LSMC_DEGREE, backward=0)
    u_card = american_cuda.monitor_underliers(price_rows, params, extra_rows=var_rows, **est)
    u_cpu = american_cuda.monitor_underliers(price_rows.cpu(), params.cpu(),
                                             extra_rows=var_rows.cpu(), **est)
    strike, df = params[:, 1].cpu().double(), torch.exp(-params[:, 3] * params[:, 2]).cpu().double()
    cf_card = (strike[:, None, None] - u_card.cpu().double()) * df[:, None, None]
    cf_cpu = (strike[:, None, None] - u_cpu.double()) * df[:, None, None]
    flip_share = float((cf_card - cf_cpu).abs().gt(1e-4 * strike[:, None, None]).double().mean())
    mean_rel = abs(float(cf_card.mean()) - float(cf_cpu.mean())) / abs(float(cf_cpu.mean()))
    if flip_share > TORCH_FLIP_SHARE or mean_rel > TORCH_MEAN_RTOL:
        raise AssertionError(f"torch estimator card vs CPU: {flip_share:.4f} flipped, mean off "
                             f"{mean_rel:.2e}")
    phase("backward-american-dynamics", rows="heston", backward="torch estimator",
          card_vs_cpu_shape=f"2x64x{COLS}x{STEPS}", card_vs_cpu_flip_share=f"{flip_share:.5f}",
          card_vs_cpu_mean_rel=f"{mean_rel:.3e}")


def phase_backward_american_dynamics(device: torch.device, sass: dict[str, tuple[float, str]],
                                     max_sm_hz: float) -> dict[str, dict[str, object]]:
    """The single-state backward on the Merton and the geometric basket rows
    and the two-state backward on Heston's and the arithmetic basket's two
    row sets, put and call: bit-equal to the twin (0 flips) on both routes;
    the two-state one against the torch estimator on the card (at most 2% of
    paths flipped, the mean cashflow within 2e-3); the torch estimator on the
    card against its CPU run (``estimator_card_vs_cpu``); then the two-state
    backward timed at the training chunk on Heston rows with its peak memory,
    beside the torch estimator it replaced, and at the streamed shape."""
    record: dict[str, dict[str, object]] = {}
    for case in ("merton", "basket3_geometric", "heston", "basket3_arithmetic"):
        params, keys = kernel_inputs(device, AMERICAN_CONTRACTS, 23,
                                     DYNAMICS_KERNELS[case][0])
        price_rows, extra = dynamics_rows(case, params, keys, timesteps=STEPS, rows=ROWS,
                                          cols=COLS, exercise_every=1)
        name = "lsmc_backward" if extra is None else "lsmc_two_state"
        disc, df = american_cuda.monitor_discounts(params, timesteps=STEPS, exercise_every=1)
        strike = params[:, 1].contiguous()
        for put in (True, False):
            kw = dict(strike=strike, disc=disc, df=df, put=put, basis_degree=LSMC_DEGREE,
                      extra_rows=extra)
            flips = backward_against_twin(name, price_rows, kw)
            got = american_cuda.lsmc_backward_cuda(price_rows, **kw)
            cf_got = (strike[:, None, None] - got) * df[:, None, None]
            found = dict(mean_cashflow=round(float(cf_got.double().mean()), 6))
            if extra is not None:
                cf_torch = american.lsmc_backward(price_rows, strike=strike, disc=disc,
                                                  dtype=torch.float32, put=put,
                                                  basis_degree=LSMC_DEGREE, extra_rows=extra)
                u_torch = strike[:, None, None] - cf_torch / df[:, None, None]
                flip_share = float((got != u_torch).float().mean())
                mean_torch = float(cf_torch.double().mean())
                mean_rel = abs(found["mean_cashflow"] - mean_torch) / abs(mean_torch)
                if flip_share > TORCH_FLIP_SHARE or mean_rel > TORCH_MEAN_RTOL:
                    raise AssertionError(f"{case} put={put}: vs the torch estimator "
                                         f"{flip_share:.4f} flipped, mean off {mean_rel:.2e}")
                found.update(torch_estimator_flip_share=f"{flip_share:.5f}",
                             torch_estimator_mean_rel=f"{mean_rel:.3e}")
                del cf_torch, u_torch
            phase("backward-american-dynamics", rows=case, kernel=name,
                  side="put" if put else "call",
                  shape=f"{AMERICAN_CONTRACTS}x{ROWS}x{COLS}x{STEPS}", twin_flips=flips,
                  twin_bit_equal=True, both_routes_bit_equal=True, **found)
            del got, cf_got
        del price_rows, extra
        torch.cuda.empty_cache()
    estimator_card_vs_cpu(device)
    # timed: the training chunk of Heston rows (resident), the streamed shape
    params, keys = kernel_inputs(device, CHUNK, 25, "heston")
    price_rows, var_rows = american_cuda.simulate_heston_american_rows_cuda(
        params, keys, timesteps=STEPS, rows=ROWS, cols=COLS, exercise_every=1)
    est = dict(timesteps=STEPS, exercise_every=1, option=american.OptionSide.PUT,
               basis_degree=LSMC_DEGREE, extra_rows=var_rows)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    american_cuda.monitor_underliers(price_rows, params, backward=4, **est)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated(device) - base) / 1e9
    torch_ms = cuda_ms(lambda: american_cuda.monitor_underliers(price_rows, params, backward=0,
                                                                **est), iters=1, warmup=1)
    torch.cuda.empty_cache()
    disc, df = american_cuda.monitor_discounts(params, timesteps=STEPS, exercise_every=1)
    kw = dict(strike=params[:, 1].contiguous(), disc=disc, df=df, put=True,
              basis_degree=LSMC_DEGREE, extra_rows=var_rows)
    record["lsmc_two_state"] = time_backward(
        "lsmc_two_state", price_rows, kw, sass, max_sm_hz, peak_gb_above_rows=round(peak_gb, 3),
        monitor_rows_gb=round(2 * CHUNK * ROWS * COLS * STEPS * 4 / 1e9, 3),
        torch_estimator_ms=f"{torch_ms:.3f}",
        torch_estimator_before_ms=TORCH_ESTIMATOR_BEFORE_MS)
    del price_rows, var_rows
    torch.cuda.empty_cache()
    rows, cols = LSMC_SHAPES["lsmc_backward_streamed"]
    params, keys = kernel_inputs(device, AMERICAN_CONTRACTS, 26, "heston")
    price_rows, var_rows = american_cuda.simulate_heston_american_rows_cuda(
        params, keys, timesteps=STEPS, rows=rows, cols=cols, exercise_every=1)
    disc, df = american_cuda.monitor_discounts(params, timesteps=STEPS, exercise_every=1)
    kw = dict(strike=params[:, 1].contiguous(), disc=disc, df=df, put=True,
              basis_degree=LSMC_DEGREE, extra_rows=var_rows)
    flips = backward_against_twin("lsmc_two_state_streamed", price_rows, kw)
    record["lsmc_two_state_streamed"] = time_backward(
        "lsmc_two_state_streamed", price_rows, kw, sass, max_sm_hz, twin_flips=flips)
    del price_rows, var_rows
    torch.cuda.empty_cache()
    return record


def family_lsmc(device: torch.device, model: ModelKind, contract: dict[str, float],
                option: str, seed: int, spec: object | None = None) -> tuple[float, float, float]:
    """``(price, SE, same-path European)`` of one contract on the "cuda"
    engine: its monitor kernel over 1,048,576 paths and 16 dates, then the
    backward the engine runs for the family; the European leg from the last
    row (maturity)."""
    params = torch.tensor([list(contract.values())], dtype=torch.float32, device=device)
    keys = rng.fold_in(rng.prng_key(seed, device), torch.arange(1, device=device))
    price_rows, extra = american_cuda.american_rows_cuda(
        params, keys, model=model, spec=spec, timesteps=STEPS, rows=ROWS, cols=COLS,
        exercise_every=1)
    backward = american_cuda.cuda_backward_version(dtype=torch.float32, n_monitor=STEPS,
                                                   two_state=extra is not None)
    u = american_cuda.monitor_underliers(
        price_rows, params, timesteps=STEPS, exercise_every=1,
        option=american.OptionSide(option), basis_degree=LSMC_DEGREE, extra_rows=extra,
        backward=backward)
    k, df = contract["strike"], math.exp(-contract["rate"] * contract["maturity"])
    cf = (k - u.double().reshape(-1)) * df
    last = price_rows[0, -1].double().reshape(-1)
    euro = df * torch.clamp(k - last if option == "put" else last - k, min=0.0)
    return float(cf.mean()), float(cf.std() / math.sqrt(cf.numel())), float(euro.mean())


HESTON_ORACLE = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.04, div_yield=0.0, v0=0.05,
                     kappa=1.5, theta=0.05, xi=0.4, rho=-0.6)
MERTON_ORACLE = dict(spot=100.0, strike=105.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.2,
                     lam=0.4, jump_mean=-0.1, jump_std=0.2)
# the JAX tests' basket (tests/test_american.py:700-712)
ORACLE_BASKET_KW = dict(weights=(0.5, 0.3, 0.2),
                        correlation=((1.0, 0.5, 0.2), (0.5, 1.0, 0.3), (0.2, 0.3, 1.0)),
                        spot_multipliers=(1.0, 0.9, 1.1), vol_multipliers=(1.0, 1.3, 0.7))


def phase_oracle_american_dynamics(device: torch.device) -> None:
    """The JAX tests' identities (tests/test_american.py:584-1012) on the
    card at 1,048,576 paths and 16 dates a contract."""
    lines = []
    c = HESTON_ORACLE
    price, se, euro = family_lsmc(device, ModelKind.HESTON, c, "call", 70)
    call, _ = heston_call_price(**c)
    lines.append(("heston q=0 call", price, se, euro, call,
                  abs(price - call) < 4.0 * se + 0.02 * call
                  and abs(price - euro) < max(3.0 * se, 0.005 * euro)))
    c = dict(HESTON_ORACLE, strike=105.0, rate=0.07)
    price, se, euro = family_lsmc(device, ModelKind.HESTON, c, "put", 71)
    lines.append(("heston r=7% K=105 put premium", price, se, euro, None, price > euro + 0.1))
    for label, over, option in (("merton q=0 call", dict(strike=95.0, rate=0.03), "call"),
                                ("merton r=0 put", dict(rate=0.0, div_yield=0.02), "put")):
        c = dict(MERTON_ORACLE, **over)
        price, se, euro = family_lsmc(device, ModelKind.MERTON_JUMP, c, option, 72)
        series = merton_call_price(**c)[0 if option == "call" else 1]
        lines.append((label, price, se, euro, series, abs(price - series) < 4.0 * se
                      and abs(price - euro) < max(3.0 * se, 0.005 * euro)))
    c = dict(MERTON_ORACLE, rate=0.07)
    price, se, euro = family_lsmc(device, ModelKind.MERTON_JUMP, c, "put", 73)
    lines.append(("merton r=7% put premium", price, se, euro, None, price > euro + 0.1))
    geo = build_basket_spec(**ORACLE_BASKET_KW, combine="geometric").expect("spec")
    c = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25)
    price, se, euro = family_lsmc(device, ModelKind.BASKET_GBM, c, "put", 74, geo)
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(
        torch.tensor(list(c.values()), dtype=torch.float64), geo)
    tree = american.bermudan_tree_price(spot=g0, strike=c["strike"], maturity=c["maturity"],
                                        rate=c["rate"], div_yield=div_eff, vol=vol_eff,
                                        exercise_dates=STEPS, option="put")
    lines.append(("geometric basket put vs tree", price, se, euro, tree,
                  abs(price - tree) <= max(4.0 * se, 0.005 * tree)))
    arith = build_basket_spec(**ORACLE_BASKET_KW).expect("spec")
    for label, over, option in (("arithmetic basket r=0 put", dict(strike=105.0, rate=0.0), "put"),
                                ("arithmetic basket q=0 call", dict(strike=95.0, rate=0.05),
                                 "call")):
        c = dict(spot=100.0, maturity=1.0, div_yield=0.0, vol=0.25, **over)
        c = {k: c[k] for k in ("spot", "strike", "maturity", "rate", "div_yield", "vol")}
        price, se, euro = family_lsmc(device, ModelKind.BASKET_GBM, c, option, 75, arith)
        lines.append((label, price, se, euro, None, abs(price - euro) <= max(3.0 * se,
                                                                             0.005 * euro)))
    for label, price, se, euro, oracle, ok in lines:
        phase("oracle-american-dynamics", contract=label, paths=ROWS * COLS, dates=STEPS,
              price=round(price, 5), se=f"{se:.2e}", same_path_european=round(euro, 5),
              premium=round(price - euro, 5),
              oracle="none" if oracle is None else round(oracle, 5), ok=ok)
        if not ok:
            raise AssertionError(f"oracle-american-dynamics {label}: {price:.5f} ± {se:.1e}, "
                                 f"European {euro:.5f}, oracle {oracle}")


HESTON_AMERICAN_CHUNK = CHUNK  # the production chunk (PERF.md §5: its peak memory)


def american_dynamics_config(payoff: PayoffKind = PayoffKind.AMERICAN_PUT, *, rows: int = ROWS,
                           model: str = "heston", **knobs: object) -> GbmCVNNPricerConfig:
    """An American pricer under the family's dynamics and bounds (bench.py's
    Heston :535-552, Merton :597-603, basket :578), the production head,
    normalization none, 16 dates, degree 5."""
    family = {"heston": "heston", "merton_jump": "merton", "basket_gbm": "basket"}[model]
    sim = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=rows, mc_seed=7,
        implementation="cuda", model=model, payoff=payoff.value, normalization="none",
        **knobs).expect("american sim")
    return GbmCVNNPricerConfig(sim=sim, bounds=bounds_for(payoff, family), cvnn=production_cvnn(),
                               normalize_inputs=True)


def phase_train_heston_american(device: torch.device) -> GbmCVNNPricer:
    """3 steps of the Heston American put at the production batch: one
    monitor-kernel launch and one two-state backward per chunk (backward 4
    recorded, the torch estimator never run), stream american_heston v2; the
    step's peak device memory."""
    pricer = GbmCVNNPricer.create(american_dynamics_config(), device=device).expect("heston amer")
    torch.cuda.reset_peak_memory_stats(device)
    (losses, seconds), moved = launched_by(
        lambda: train_steps(pricer, 3, chunk=HESTON_AMERICAN_CHUNK))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launched = {g: moved.get(g, 0) for g in ("american_heston", "lsmc_two_state")}
    estimator_calls = moved.get("torch_estimator", 0)
    snap = pricer.snapshot()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"heston american: non-finite training losses {losses}")
    if set(launched.values()) != {3 * BATCH // HESTON_AMERICAN_CHUNK} or estimator_calls:
        raise AssertionError(f"heston american: launches {launched} and {estimator_calls} torch "
                             f"estimator calls in 3 steps")
    want = american_cuda.LSMC_BACKWARD_VERSIONS["cuda_two_state"]
    stream = gbm_cuda.CUDA_STREAM_VERSIONS["american_heston"]
    if (snap.sim.implementation.value, snap.lsmc_backward_version,
            snap.cuda_stream_version) != ("cuda", want, stream):
        raise AssertionError(f"heston american: engine {snap.sim.implementation.value}, backward "
                             f"v{snap.lsmc_backward_version}, stream v{snap.cuda_stream_version}")
    phase("train-heston-american", model="heston", payoff=snap.sim.payoff.value, inputs=10,
          engine="cuda", stream=f"american_heston_v{stream}",
          lsmc_backward_version=snap.lsmc_backward_version,
          normalization=snap.sim.normalization.value, losses=losses.tolist(), launches=launched,
          torch_estimator_calls=estimator_calls, step_seconds=[round(s, 4) for s in seconds],
          median_step_s=f"{statistics.median(seconds):.4f}", peak_memory_gb=round(peak_gb, 3),
          monitor_rows_gb_per_chunk=round(2 * HESTON_AMERICAN_CHUNK * STEPS * ROWS * COLS * 4
                                          / 1e9, 3),
          paths_per_contract=ROWS * COLS, batch=BATCH, chunk=HESTON_AMERICAN_CHUNK)
    return pricer


CURVED_HESTON_REFUSAL = (
    "term", "heston",
    "LSMC early exercise under term structures is supported for GBM dynamics only (the "
    "curved-coefficient lattice oracle and per-segment discount backward exist for the "
    "single-factor lognormal family)")
# one step at batch 64 each (batch 4 at 4,194,304 paths a contract): (label,
# model, payoff, knobs, batch rows, backward, the counts that must move: the
# kernels' launches and, for cross-fit alone, the torch estimator's runs)
DYNAMICS_FAMILIES = [
    ("merton put", "merton_jump", PayoffKind.AMERICAN_PUT, {}, ROWS, 3,
     ("american_merton", "lsmc_backward")),
    ("arithmetic basket put", "basket_gbm", PayoffKind.AMERICAN_PUT, dict(basket=BASKET_SPEC),
     ROWS, 4, ("american_basket", "lsmc_two_state")),
    ("geometric basket put", "basket_gbm", PayoffKind.AMERICAN_PUT, dict(basket=GEOMETRIC_SPEC),
     ROWS, 3, ("american_basket", "lsmc_backward")),
    ("heston call", "heston", PayoffKind.AMERICAN_CALL, {}, ROWS, 4,
     ("american_heston", "lsmc_two_state")),
    ("heston cross-fit", "heston", PayoffKind.AMERICAN_PUT, dict(lsmc_cross_fit=True), ROWS, 0,
     ("american_heston", "torch_estimator")),
    ("merton antithetic", "merton_jump", PayoffKind.AMERICAN_PUT, dict(antithetic=True), ROWS, 3,
     ("american_merton", "lsmc_backward")),
    ("heston 4,194,304 paths", "heston", PayoffKind.AMERICAN_PUT, {}, 8192, 4,
     ("american_heston", "lsmc_two_state_streamed")),
]
BACKWARD_GROUPS = ("lsmc_backward", "lsmc_backward_streamed", "lsmc_two_state",
                   "lsmc_two_state_streamed", "torch_estimator")


def phase_families_american_dynamics(device: torch.device) -> None:
    """One step per pricer of DYNAMICS_FAMILIES: the engine, stream and
    backward recorded, the monitor kernel and the backward of the recorded
    version launched once (no other backward), the torch estimator run only
    for cross-fit, a finite loss, the learned side finite and the other NaN;
    then a curved-rate Heston American config, refused with JAX's field,
    value and reason."""
    for label, model, payoff, knobs, rows, backward, groups in DYNAMICS_FAMILIES:
        pricer = GbmCVNNPricer.create(
            american_dynamics_config(payoff, rows=rows, model=model, **knobs),
            device=device).expect(label)
        batch = 4 if rows > ROWS else PAYOFF_BATCH
        (losses, seconds), moved = launched_by(
            lambda: train_steps(pricer, 1, batch=batch, chunk=batch))
        launched = {g: moved.get(g, 0) for g in (groups[0], *BACKWARD_GROUPS)}
        snap = pricer.snapshot()
        want = {g: (1 if g in groups else 0) for g in launched}
        stream = gbm_cuda.CUDA_STREAM_VERSIONS[f"american_{model}"]
        if (snap.sim.implementation.value, snap.lsmc_backward_version,
                snap.cuda_stream_version) != ("cuda", backward, stream) or launched != want:
            raise AssertionError(f"{label}: engine {snap.sim.implementation.value}, backward "
                                 f"v{snap.lsmc_backward_version}, launches and torch "
                                 f"estimator calls {launched}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{label}: loss {losses}")
        family = family_of(snap.sim)
        pred = check_prices(pricer, held_out(payoff, 8, family), device)
        phase("families-american-dynamics", pricer=label, model=model, payoff=payoff.value,
              engine="cuda", stream=f"american_{model}_v{snap.cuda_stream_version}",
              lsmc_backward_version=backward,
              launches={g: n for g, n in launched.items() if n and g != "torch_estimator"},
              torch_estimator_calls=launched["torch_estimator"], paths_per_contract=rows * COLS,
              batch=batch, loss=float(losses[0]), step_s=round(seconds[0], 4),
              prices=np.round(pred.call if payoff == PayoffKind.AMERICAN_CALL else pred.put,
                              5)[:3].tolist(),
              other_side="NaN")
        del pricer
        torch.cuda.empty_cache()
    refused = build_simulation_params(
        timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, mc_seed=7,
        implementation="cuda", model="heston", payoff="american_put", normalization="none",
        term=TermStructure(rate_shape=term_of(STEPS).rate_shape))
    got = (refused.error.field, refused.error.value, refused.error.reason) \
        if refused.is_failure() else None
    if got != CURVED_HESTON_REFUSAL:
        raise AssertionError(f"curved Heston American: {got}")
    phase("families-american-dynamics", pricer="curved-rate heston put", refused=True,
          field=got[0], value=got[1])


# --------------------------------------------------------------------------
# 11. profile
# --------------------------------------------------------------------------


# phase 27: the production pricers through their bytes (label, kernel groups, chunk)
BYTES_PRICERS = (("terminal", ("terminal",), CHUNK),
                 ("american", ("american_gbm", "lsmc_backward"), CHUNK),
                 ("heston-american", ("american_heston", "lsmc_two_state"),
                  HESTON_AMERICAN_CHUNK))


def serve_equal(served: GbmCVNNPricer, reference: dict[int, object], rows: np.ndarray,
                what: str) -> None:
    """``served`` prices bit-equal to ``reference`` (its prices at each N)."""
    for n, want in reference.items():
        got = served.predict_price(rows[:n])
        if not (np.array_equal(got.put, want.put, equal_nan=True)
                and np.array_equal(got.call, want.call, equal_nan=True)):
            raise AssertionError(f"{what}: served prices differ at N={n}")


def load_served(store: AsyncBlockchainModelStore, mode: object) -> tuple[object, float]:
    """The model an ``InferenceClient`` in ``mode`` loads, and the ms it took."""

    async def load() -> object:
        async with InferenceClient(store, mode, poll_interval=0.05) as client:
            return client.get_model()

    start = time.perf_counter()
    loaded = asyncio.run(load())
    return loaded, (time.perf_counter() - start) * 1e3


def phase_checkpoint_store(device: torch.device, smi: str, label: str, pricer: GbmCVNNPricer,
                           groups: tuple[str, ...], chunk: int) -> None:
    """Phase 27 for one production pricer: its snapshot through serialized
    bytes, a filesystem chain and the inference client, held bit for bit to
    the in-memory path."""
    snap = pricer.snapshot()
    sim = snap.sim
    rows = held_out(sim.payoff, 64, family_of(sim))
    genesis_prices = {n: pricer.predict_price(rows[:n]) for n in (1, 7, 64)}
    start = time.perf_counter()
    data, digest = serialize_checkpoint(snap)
    encode_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    decoded = deserialize_checkpoint(data, expected_hash=digest).expect("decode")
    decode_ms = (time.perf_counter() - start) * 1e3
    versions = ("cuda_stream_version", "lsmc_backward_version")
    if any(getattr(decoded, v) != getattr(snap, v) for v in versions) or (
            decoded.provenance != snap.provenance or decoded.provenance.jax_env is not None):
        raise AssertionError(f"{label}: the bytes read back {decoded.cuda_stream_version}, "
                             f"{decoded.lsmc_backward_version}, {decoded.provenance}")
    flipped = bytes([data[0] ^ 0x01]) + data[1:]
    flip_error = deserialize_checkpoint(flipped, expected_hash=digest)
    if not isinstance(getattr(flip_error, "error", None), ChecksumMismatch):
        raise AssertionError(f"{label}: a flipped byte gave {flip_error!r}")
    older, _ = serialize_checkpoint(
        dataclasses.replace(decoded, cuda_stream_version=decoded.cuda_stream_version - 1))
    refused = GbmCVNNPricer.create(deserialize_checkpoint(older).expect("older"), device=device)
    if type(getattr(refused, "error", None)).__name__ != "EngineMismatch":
        raise AssertionError(f"{label}: stream v{decoded.cuda_stream_version - 1} gave {refused}")
    with tempfile.TemporaryDirectory() as root:
        store = AsyncBlockchainModelStore(FileSystemObjectStore(root, label))
        start = time.perf_counter()
        genesis = asyncio.run(store.commit(data, digest, "genesis")).expect("commit genesis")
        commit_ms = [(time.perf_counter() - start) * 1e3]
        inner_commit = make_commit_fn(store)

        def timed_commit(config: GbmCVNNPricerConfig, message: str) -> None:
            begin = time.perf_counter()
            inner_commit(config, message)
            commit_ms.append((time.perf_counter() - begin) * 1e3)

        loaded, pinned_ms = load_served(store, PinnedMode(counter=genesis.counter))
        serve_equal(GbmCVNNPricer.create(loaded.config, device=device).expect("pinned"),
                    genesis_prices, rows, f"{label} pinned genesis")
        in_memory = GbmCVNNPricer.create(snap, device=device).expect("from snapshot")
        want, _ = train_steps(in_memory, 2, batch=BATCH, chunk=chunk)
        from_bytes = GbmCVNNPricer.create(decoded, device=device).expect("from bytes")
        cfg = build_training_config(num_batches=1, batch_size=BATCH, learning_rate=1e-3,
                                    contract_chunk=chunk).expect("training config")
        gbm_cuda.reset_launches()  # the bytes path's count starts here
        got = [from_bytes.train(cfg).expect("step 1").final_loss,
               from_bytes.train(cfg, commit_plan=FinalCommit(),
                                commit_fn=timed_commit).expect("step 2").final_loss]
        launches = {g: gbm_cuda.LAUNCHES_BY_BRANCH[g] for g in groups}
        if not np.array_equal(want, np.asarray(got)):
            raise AssertionError(f"{label}: resume from bytes {got} != from snapshot {want}")
        if set(launches.values()) != {2 * BATCH // chunk}:
            raise AssertionError(f"{label}: the bytes path launched {launches}")
        if len(commit_ms) != 2:
            raise AssertionError(f"{label}: FinalCommit committed {len(commit_ms) - 1} times")
        verdict = asyncio.run(verify_chain_detailed(store)).expect("verify")
        if verdict != ChainValid(versions=2):
            raise AssertionError(f"{label}: chain {verdict}")
        loaded, tracking_ms = load_served(store, TrackingMode())
        if (loaded.version.counter, loaded.config.global_step) != (1, snap.global_step + 2):
            raise AssertionError(f"{label}: tracking loaded {loaded.version}")
        head_prices = {n: in_memory.predict_price(rows[:n]) for n in (1, 7, 64)}
        serve_equal(GbmCVNNPricer.create(loaded.config, device=device).expect("tracking"),
                    head_prices, rows, f"{label} tracking head")
    env = decoded.provenance.torch_env
    phase("checkpoint-store", pricer=label, model=sim.model.value, payoff=sim.payoff.value,
          stream_version=decoded.cuda_stream_version,
          lsmc_backward_version=decoded.lsmc_backward_version, bytes=len(data), sha256=digest,
          encode_ms=f"{encode_ms:.3f}", decode_ms=f"{decode_ms:.3f}",
          torch_env=repr((env.torch_version, env.cuda_version, env.device_kind,
                          env.python_version)),
          resumed_losses=[float(x) for x in got], resume_bit_equal=True, launches=launches,
          commit_ms=[round(x, 3) for x in commit_ms], load_ms={"pinned": round(pinned_ms, 3),
                                                             "tracking": round(tracking_ms, 3)},
          served_bit_equal="N=1,7,64 pinned and tracking", checksum_refused=True,
          older_stream_refused=True, chain="valid, 2 versions", nvidia_smi=repr(smi))


# --------------------------------------------------------------------------
# 28. the training loop: interval commits, metrics, effects, divergence, profile
# --------------------------------------------------------------------------


def chain_payloads(store: AsyncBlockchainModelStore) -> list[tuple[str, bytes]]:
    async def read() -> list[tuple[str, bytes]]:
        versions = (await store.list_versions()).expect("versions")
        return [(v.message, (await store.load_checkpoint(v)).expect("payload"))
                for v in versions]

    return asyncio.run(read())


def warm_step_seconds(pricer: GbmCVNNPricer, n: int, **plan: object) -> list[float]:
    """``n`` single-step ``train`` calls under ``plan``, each on the host
    clock to a synchronised end."""
    cfg = build_training_config(num_batches=1, batch_size=BATCH, learning_rate=1e-3,
                                contract_chunk=CHUNK).expect("training config")
    seconds = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        pricer.train(cfg, **plan).expect("warm step")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    return seconds


def phase_train_loop(device: torch.device, smi: str, snap: GbmCVNNPricerConfig) -> None:
    """Phase 28: the TERMINAL pricer's snapshot driven through the rest of the
    training loop at full width on the "cuda" engine — interval commits,
    ``NoCommit``, ``train_via_effects`` plainly and inside a running event
    loop, the metrics callbacks and the rates they report, a diverged run,
    ``profile_dir``, the FLOP count and MFU, and host-clock costs."""
    steps = 5
    cfg = build_training_config(num_batches=steps, batch_size=BATCH, learning_rate=1e-3,
                                contract_chunk=CHUNK).expect("training config")
    per_step = BATCH // CHUNK  # kernel #1's launches a step
    base = snap.global_step

    def launched(fn):
        before = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"]
        out = fn()
        moved = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"] - before
        if moved != steps * per_step:
            raise AssertionError(f"train-loop: kernel #1 launched {moved} times in {steps} "
                                 f"steps, want {steps * per_step}")
        return out

    gbm_cuda.reset_launches()  # the training loop's path starts here
    with tempfile.TemporaryDirectory() as root:
        stores = {name: AsyncBlockchainModelStore(FileSystemObjectStore(root, name))
                  for name in ("train", "effects", "effects-in-loop")}
        plan = FinalAndIntervalCommit(interval=2)
        interval = GbmCVNNPricer.create(snap, device=device).expect("interval")
        segments, step_metrics = [], []
        interval.set_segment_callback(segments.append)
        interval.set_step_callback(step_metrics.append)
        commit_steps = []
        inner = make_commit_fn(stores["train"])

        def recording_commit(config: GbmCVNNPricerConfig, message: str) -> None:
            commit_steps.append(config.global_step - base)
            inner(config, message)

        result = launched(lambda: interval.train(cfg, commit_plan=plan,
                                                 commit_fn=recording_commit).expect("interval"))
        if [len(s.losses) for s in segments] != [2, 2, 1] or commit_steps != [2, 4, 5]:
            raise AssertionError(f"train-loop: segments {[len(s.losses) for s in segments]}, "
                                 f"commits at {commit_steps}")
        starts = [s.start_step - base for s in segments]
        if starts != [1, 3, 5]:
            raise AssertionError(f"train-loop: segment start steps {starts}")
        seg_losses = np.concatenate([s.losses for s in segments])
        if not (np.array_equal(seg_losses, result.losses) and np.array_equal(
                [m.loss for m in step_metrics], result.losses)):
            raise AssertionError("train-loop: the callbacks' losses differ from the result's")
        verdict = asyncio.run(verify_chain_detailed(stores["train"])).expect("verify")
        if verdict != ChainValid(versions=3):
            raise AssertionError(f"train-loop: chain {verdict}")
        plain = launched(lambda: GbmCVNNPricer.create(snap, device=device).expect("plain")
                         .train(cfg).expect("NoCommit"))
        if not (np.array_equal(plain.losses, result.losses)
                and np.array_equal(plain.grad_norms, result.grad_norms)):
            raise AssertionError(f"train-loop: NoCommit {plain.losses} != interval "
                                 f"{result.losses}")
        effects = {}
        for name, inside in (("effects", False), ("effects-in-loop", True)):
            pricer = GbmCVNNPricer.create(snap, device=device).expect(name)

            def run(pricer=pricer, name=name):
                return pricer.train_via_effects(cfg, commit_plan=plan,
                                                commit_fn=make_commit_fn(stores[name]))

            async def in_loop(run=run):
                return run()

            effects[name] = launched(
                lambda: (asyncio.run(in_loop()) if inside else run()).expect(name))
        want = chain_payloads(stores["train"])
        for name, got in effects.items():
            if not np.array_equal(got.losses, result.losses):
                raise AssertionError(f"train-loop: {name} losses {got.losses}")
            if chain_payloads(stores[name]) != want:
                raise AssertionError(f"train-loop: {name} committed other messages or bytes")
    schedule = LRScheduleConfig(peak=2e-3, decay_steps=base + 8, warmup_steps=base + 2,
                                end_value=1e-5)
    scheduled = GbmCVNNPricer.create(snap, device=device).expect("scheduled")
    rates = []
    scheduled.set_step_callback(lambda m: rates.append(m.learning_rate))
    launched(lambda: scheduled.train(
        build_training_config(num_batches=steps, batch_size=BATCH, learning_rate=1e-3,
                              contract_chunk=CHUNK, lr_schedule=schedule).expect("scheduled"),
        commit_plan=IntervalCommit(interval=2), commit_fn=lambda c, m: None).expect("scheduled"))
    if not np.array_equal(np.asarray(rates, np.float32), schedule_rates(schedule, base, steps)):
        raise AssertionError(f"train-loop: reported rates {rates}")
    model_state = {k: v.copy() for k, v in snap.model_state.items()}
    planted = sorted(k for k in model_state if k.endswith("w_re"))[0]
    model_state[planted].flat[0] = np.nan
    diverged = GbmCVNNPricer.create(dataclasses.replace(snap, model_state=model_state),
                                    device=device).expect("diverged")
    before = diverged.snapshot()
    failure = diverged.train(cfg, commit_plan=IntervalCommit(interval=2),
                             commit_fn=lambda c, m: None)
    after = diverged.snapshot()
    same = all(np.array_equal(after.model_state[k], before.model_state[k], equal_nan=True)
               for k in before.model_state) and all(
        np.array_equal(after.optimizer_state.nu[k], before.optimizer_state.nu[k])
        for k in before.optimizer_state.nu) and (
        after.global_step, after.sobol_skip, after.sim.skip, after.optimizer_state.count) == (
        before.global_step, before.sobol_skip, before.sim.skip, before.optimizer_state.count)
    if type(getattr(failure, "error", None)).__name__ != "NonFiniteLoss" or not same or (
            failure.error.step != base + 2):
        raise AssertionError(f"train-loop: diverged run gave {failure}, state restored {same}")
    with tempfile.TemporaryDirectory() as trace_dir:
        profiled_pricer = GbmCVNNPricer.create(snap, device=device).expect("profiled")
        profiled_pricer.train(
            build_training_config(num_batches=2, batch_size=BATCH, learning_rate=1e-3,
                                  contract_chunk=CHUNK).expect("profiled"),
            commit_plan=IntervalCommit(interval=1), commit_fn=lambda c, m: None,
            profile_dir=trace_dir).expect("profiled")
        (trace,) = Path(trace_dir).glob("*.pt.trace.json")
        trace_bytes = trace.stat().st_size
        events = json.loads(trace.read_text())["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    path_events = sum("gbm_paths" in e.get("name", "") for e in kernel_events)
    ranges = sum(e.get("name") == "train_segment" and e.get("cat") == "user_annotation"
                 for e in events)
    if not kernel_events or path_events != 2 * per_step or ranges != 2:
        raise AssertionError(f"train-loop: trace holds {len(kernel_events)} kernel events, "
                             f"{path_events} gbm_paths, {ranges} train_segment ranges")
    warm = GbmCVNNPricer.create(snap, device=device).expect("warm")
    warm_step_seconds(warm, 2)
    nocommit_s = warm_step_seconds(warm, 7)
    with tempfile.TemporaryDirectory() as root:
        store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "interval-1"))
        interval_s = warm_step_seconds(warm, 7, commit_plan=IntervalCommit(interval=1),
                                       commit_fn=make_commit_fn(store))
    adam = AdamState.zeros_like(model_params(warm.model))
    copy_ms = []
    for _ in range(21):
        torch.cuda.synchronize()
        start = time.perf_counter()
        SegmentStart.take(warm.model, adam)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - start) * 1e3)
    copy_bytes = sum(t.numel() * t.element_size() for t in warm.model.state_dict().values())
    matmul = train_step_matmul_flops(warm.model, BATCH)
    step_s = statistics.median(nocommit_s)
    tflops, share = mfu(matmul, 1.0 / step_s)
    phase("train-loop", pricer="terminal", snapshot_step=base, steps=steps,
          segments=[len(s.losses) for s in segments], segment_start_steps=starts,
          commits_at=commit_steps, chain="valid, 3 versions", nocommit_bit_equal=True,
          effects_bit_equal="plain and inside a running loop, messages and bytes equal",
          losses=result.losses.tolist(), callbacks_bit_equal=True,
          scheduled_rates=[float(r) for r in rates],
          launches_per_step=per_step, launch_checked_runs=5,
          phase_launches=gbm_cuda.LAUNCHES_BY_BRANCH["terminal"],
          diverged=f"NonFiniteLoss at step {failure.error.step}, pre-segment state kept",
          trace_bytes=trace_bytes, trace_kernel_events=len(kernel_events),
          trace_gbm_paths_events=path_events, trace_train_segment_ranges=ranges,
          matmul_flops_per_step=matmul, fft_flops_per_step=fft_flops(BATCH, COLS),
          path_steps_per_step=sim_path_steps(BATCH, ROWS, COLS, STEPS),
          warm_step_mfu=f"{share:.6%}", warm_step_tflops=f"{tflops:.6f}",
          nocommit_step_s=[round(x, 5) for x in nocommit_s],
          nocommit_median_s=f"{step_s:.5f}",
          interval1_step_s=[round(x, 5) for x in interval_s],
          interval1_median_s=f"{statistics.median(interval_s):.5f}",
          segment_start_copy_ms=f"{statistics.median(copy_ms):.4f}",
          segment_start_copy_bytes=copy_bytes, nvidia_smi=repr(smi))


def profiled(fn) -> tuple[float, float, int, list[tuple[str, int, float]]]:
    """Wall ms, device kernel ms, kernel launches and the heaviest kernels of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return wall, busy, sum(e.count for e in rows), [
        (e.key[:72], e.count, round(e.self_device_time_total / 1e3, 3)) for e in top
    ]


# --------------------------------------------------------------------------
# 29. greeks
# --------------------------------------------------------------------------

GREEKS_CONTRACT = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
                       vol=0.25)
GREEKS_BARRIER_REL = 1.35
# the discrete-barrier lattice of phase 29's six oracle prices (4097 points,
# its error by halving: ≈ 1 s a price on the card's host where phase 3's 8193
# take ≈ 4)
GREEKS_BARRIER_GRID = 4097
GREEKS_FIELDS = ("spot", "maturity", "rate", "vol")  # price and these: the 2% gate


def greeks_sim(implementation: str = "cuda", **kw: object) -> SimulationParams:
    """The production shape (2048 x 512 paths, 16 steps), on the "cuda" engine
    unless said."""
    return build_simulation_params(timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS,
                                   mc_seed=7, implementation=implementation, **kw).expect("sim")


def only_launches(branch: str, fn):
    """``(fn(), its launches of ``branch``)``; raises if it launched another
    kernel or branch besides."""
    out, moved = launched_by(fn)
    if set(moved) - {branch}:
        raise AssertionError(f"greeks: launched {moved} where only {branch} should run")
    return out, moved.get(branch, 0)


def host_ms(fn) -> tuple[object, float]:
    """``(fn(), host-clock ms to a synchronised end)``."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - start) * 1e3


def backward_ms(forward, params: torch.Tensor, cot: torch.Tensor) -> float:
    """CUDA-event ms of the backward alone: ``forward(params)``'s graph kept,
    ``autograd.grad`` with the cotangent ``cot`` timed."""
    x = params.clone().requires_grad_(True)
    out = forward(x)
    return cuda_ms(lambda: torch.autograd.grad(out, x, grad_outputs=cot, retain_graph=True))


def check_greeks(label: str, mc: greeks.MCGreeks, want_price: float,
                 want: dict[str, float], *, rel: float, floor: float, price_abs: float) -> float:
    """The largest relative miss of price and ``want``'s fields; raises past
    ``rel`` (each against ``max(rel·|want|, floor)``, the price ``price_abs``)."""
    worst = abs(mc.price - want_price) / abs(want_price)
    if abs(mc.price - want_price) > max(rel * abs(want_price), price_abs):
        raise AssertionError(f"{label}: price {mc.price} vs {want_price}")
    for field, value in want.items():
        miss = abs(mc.by_field[field] - value)
        if miss > max(rel * abs(value), floor):
            raise AssertionError(f"{label}: {field} {mc.by_field[field]} vs {value}")
        worst = max(worst, miss / max(abs(value), 1e-12))
    return worst


def greeks_terminal(device: torch.device) -> dict[str, object]:
    """TERMINAL put and call on the "cuda" engine: kernel #1 three times a
    call, within 2% (abs 0.01) of analytic_greeks, gamma within 5%; the
    backward on the kernel's samples against the same rule on the twin's
    (same Philox words, rtol 2e-5); the backward's and the forward's CUDA
    ms; a bump_greeks on 13 contracts in one launch whose base row is the
    single contract's bit for bit; BlackScholes.price_to_host within 4 SE."""
    sim = greeks_sim()
    c = BlackScholesContract(**GREEKS_CONTRACT)
    if greeks.greeks_engine(sim) != SimImplementation.CUDA:
        raise AssertionError("greeks: TERMINAL on 'cuda' did not pick the kernel engine")
    out: dict[str, object] = {"launches": 0}
    for option in (greeks.OptionSide.PUT, greeks.OptionSide.CALL):
        (mc, ms), n = only_launches("terminal", lambda: host_ms(
            lambda: greeks.mc_greeks(sim, c, option=option, device=device)))
        oracle = greeks.analytic_greeks(c, option=option, device=device)
        if n != 3 or mc.engine != SimImplementation.CUDA:
            raise AssertionError(f"greeks: {option.value} launched #1 {n} times on {mc.engine}")
        worst = check_greeks(f"terminal {option.value}", mc, oracle.price,
                             {f: oracle.by_field[f] for f in GREEKS_FIELDS}, rel=0.02,
                             floor=0.01, price_abs=0.01)
        gamma_miss = abs(mc.gamma - oracle.gamma) / oracle.gamma
        if gamma_miss > 0.05:
            raise AssertionError(f"greeks: {option.value} gamma {mc.gamma} vs {oracle.gamma}")
        out["launches"] += n
        phase("greeks", case=f"terminal-{option.value}", engine=mc.engine.value, launches=n,
              price=round(mc.price, 5), oracle=round(oracle.price, 5),
              delta=round(mc.delta, 5), vega=round(mc.vega, 4), rho=round(mc.rho, 4),
              theta=round(mc.theta, 4), gamma=round(mc.gamma, 6),
              oracle_gamma=round(oracle.gamma, 6), worst_rel_miss=f"{worst:.3e}",
              gamma_rel_miss=f"{gamma_miss:.3e}", host_ms=round(ms, 3))
    # the Function's backward on the kernel's samples vs on the twin's
    params = c.as_array(torch.float32, device)[None]
    keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), sim.skip).reshape(1, 2)
    shape = dict(timesteps=STEPS, rows=ROWS, cols=COLS)
    with torch.no_grad():
        values = gbm_cuda.simulate_terminal_rows_cuda_diff(params, keys, **shape)
        twin = gbm_cuda.simulate_terminal_rows_cuda_plain(
            params, keys, scheme=PathScheme.LOG_EULER, **shape)
    cot = torch.rand(values.shape, device=device, generator=torch.Generator(device).manual_seed(29))
    got = gbm_cuda.terminal_pathwise_vjp(cot, values, params)
    want = gbm_cuda.terminal_pathwise_vjp(cot, twin, params)
    gap = float(((got - want).abs() / want.abs().clamp(min=1e-30))[:, [0, 2, 3, 4, 5]].max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_RTOL * float(want.abs().max())):
        raise AssertionError(f"greeks: backward on #1's samples vs the twin's: {got} vs {want}")
    fwd_ms = cuda_ms(lambda: gbm_cuda.simulate_terminal_rows_cuda_diff(params, keys, **shape))
    bwd_ms = backward_ms(lambda x: gbm_cuda.simulate_terminal_rows_cuda_diff(x, keys, **shape),
                         params, cot)
    out.update(forward_ms=fwd_ms, backward_ms=bwd_ms)
    phase("greeks-backward", kernel="gbm_terminal", shape=f"1x{ROWS}x{COLS}x{STEPS}",
          max_rel_vs_twin=f"{gap:.3e}", forward_ms=round(fwd_ms, 4),
          backward_ms=round(bwd_ms, 4))
    # bump-and-reprice: the 2D+1 contracts in one launch
    (bump, n_bump) = only_launches("terminal", lambda: greeks.bump_greeks(sim, c, device=device))
    if n_bump != 1:
        raise AssertionError(f"greeks: bump_greeks launched #1 {n_bump} times, want 1")
    out["launches"] += n_bump
    h = 1e-2 * params.abs().clamp(min=1e-3)
    eye = torch.eye(6, device=device) * h
    grid = torch.cat([params, params + eye, params - eye])  # what make_bump_greeks_fn prices
    with torch.no_grad():
        rows13 = gbm_cuda.simulate_terminal_rows_cuda_diff(grid, keys.expand(13, 2), **shape)
    if not torch.equal(rows13[:1], values):
        raise AssertionError("greeks: the h = 0 row of the 13-contract launch is not the base")
    # the facade on the card: normalization none, so each payoff is one path's
    plain_sim = greeks_sim(normalization="none")
    engine = BlackScholes(plain_sim, device=device)
    (host, advanced), n_host = only_launches("terminal", lambda: engine.price_to_host(c))
    prices, _ = engine.price(c)
    black = analytic.black_scholes_price(*GREEKS_CONTRACT.values())
    zs = []
    for name, pay, want_p in (("put", prices.put_payoffs, black.put),
                              ("call", prices.call_payoffs, black.call)):
        se = float(pay.double().std() / math.sqrt(pay.numel()))
        zs.append(z_score(getattr(host, name), se, float(want_p), 0.0))
    if max(zs) > 4.0 or advanced.params.skip != plain_sim.skip + 1 or n_host != 1:
        raise AssertionError(f"greeks: price_to_host z {zs}, skip {advanced.params.skip}, "
                             f"launches {n_host}")
    out["launches"] += n_host
    phase("greeks", case="bump-terminal", contracts=13, launches=n_bump, h0_row_bit_equal=True,
          price=round(bump.price, 5), delta=round(bump.delta, 5), gamma=round(bump.gamma, 6),
          facade_put=round(host.put, 5), facade_call=round(host.call, 5),
          facade_z=[round(z, 3) for z in zs], facade_skip=advanced.params.skip)
    return out


def greeks_term(device: torch.device) -> dict[str, object]:
    """A curved TERMINAL sim keeps the "cuda" engine: kernel #2 three times,
    Greeks within 4% (abs 0.006; the price 2%, abs 0.01) of autograd through
    term_effective_black; the rule on #2's samples equals it on the twin's
    bit for bit (#2 and its twin are bit-equal)."""
    term = term_of(STEPS)
    sim = greeks_sim(term=term)
    c = BlackScholesContract(**{**GREEKS_CONTRACT, "strike": 105.0})
    (mc, n) = only_launches("term_terminal", lambda: greeks.mc_greeks(
        sim, c, option=greeks.OptionSide.PUT, device=device))
    if n != 3 or mc.engine != SimImplementation.CUDA:
        raise AssertionError(f"greeks: curved TERMINAL launched #2 {n} times on {mc.engine}")
    x = c.as_array(torch.float64, device).requires_grad_(True)
    put = analytic.term_effective_black(*x, vol_shape=term.vol_shape, rate_shape=term.rate_shape,
                                        div_shape=term.div_shape).put
    (grad,) = torch.autograd.grad(put, x)
    want = dict(zip(BlackScholesContract.model_fields, grad.tolist()))
    worst = check_greeks("term put", mc, float(put.detach()), want, rel=0.04, floor=0.006,
                         price_abs=0.01)
    params = c.as_array(torch.float32, device)[None]
    keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), sim.skip).reshape(1, 2)
    shape = dict(timesteps=STEPS, rows=ROWS, cols=COLS)
    with torch.no_grad():
        values = gbm_cuda.simulate_terminal_rows_cuda_diff(params, keys, term=term, **shape)
        twin = dynamics_cuda.simulate_term_rows_cuda_plain(
            params, keys, term=term, payoff=PayoffKind.TERMINAL, **shape)
    factors = gbm_cuda.term_pathwise_factors(term, STEPS)
    cot = torch.rand(values.shape, device=device, generator=torch.Generator(device).manual_seed(30))
    if not torch.equal(gbm_cuda.terminal_pathwise_vjp(cot, values, params, factors),
                       gbm_cuda.terminal_pathwise_vjp(cot, twin, params, factors)):
        raise AssertionError("greeks: the rule on #2's samples differs from the twin's")
    fwd_ms = cuda_ms(lambda: gbm_cuda.simulate_terminal_rows_cuda_diff(params, keys, term=term,
                                                                       **shape))
    bwd_ms = backward_ms(lambda x: gbm_cuda.simulate_terminal_rows_cuda_diff(
        x, keys, term=term, **shape), params, cot)
    phase("greeks", case="term-put", engine=mc.engine.value, launches=n,
          price=round(mc.price, 5), oracle=round(float(put.detach()), 5),
          vega=round(mc.vega, 4), oracle_vega=round(want["vol"], 4),
          worst_rel_miss=f"{worst:.3e}", backward_bit_equal_to_twin=True)
    phase("greeks-backward", kernel="gbm_term_terminal", shape=f"1x{ROWS}x{COLS}x{STEPS}",
          forward_ms=round(fwd_ms, 4), backward_ms=round(bwd_ms, 4))
    return {"launches": n, "forward_ms": fwd_ms, "backward_ms": bwd_ms}


def greeks_qmc(device: torch.device) -> dict[str, object]:
    """The SOBOL_BB geometric Asian: mc_greeks runs kernel #14 (each of its
    three gradients a forward launch and the backward's launch at (0, 0,
    1)), within 1% of the closed form (fields abs 0.002); ``walk_acc``'s
    gradient against autograd through the torch scan over
    ``qmc_effective_normals`` at rtol 1e-4; the backward's CUDA ms."""
    sim = greeks_sim(payoff="asian_geometric", sampling="sobol_bb")
    sim = sim.model_copy(update={"mc_seed": QMC_SEED})
    c = BlackScholesContract(**GREEKS_CONTRACT)
    (mc, n) = only_launches("qmc_walk", lambda: greeks.mc_greeks(sim, c, device=device))
    if n != 6:
        raise AssertionError(f"greeks: SOBOL_BB geometric Asian launched #14 {n} times, want 6")
    oracle = greeks.analytic_greeks(c, payoff=PayoffKind.ASIAN_GEOMETRIC, timesteps=STEPS,
                                    device=device)
    worst = check_greeks("qmc call", mc, oracle.price, dict(oracle.by_field), rel=0.01,
                         floor=0.002, price_abs=0.005)
    # the Function's gradient vs autograd through the scan over the bridge kernel's normals
    keys = rng.fold_in(rng.prng_key(QMC_SEED, device), sim.skip).reshape(1, 2)
    dt = GREEKS_CONTRACT["maturity"] / STEPS
    v = GREEKS_CONTRACT["vol"]
    scalars = torch.tensor([[math.log(100.0)], [(0.03 - 0.01 - 0.5 * v * v) * dt],
                            [v * math.sqrt(dt)]], device=device)
    _, directions, shift, _ = qmc._draw_tables(keys, STEPS, 1, QMC_SEED)
    bridge = torch.as_tensor(qmc.brownian_bridge_matrix(STEPS), dtype=torch.float32)

    def loss(acc: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.clamp(torch.exp(acc / STEPS) - 100.0, min=0.0))

    xs = [s.clone().requires_grad_(True) for s in scalars]
    acc = qmc_cuda.walk_acc(directions, shift, bridge, 0, *xs, timesteps=STEPS,
                            count=ROWS * COLS)
    got = torch.autograd.grad(loss(acc), xs)
    eff = qmc.qmc_effective_normals(keys, timesteps=STEPS, rows=ROWS, cols=COLS,
                                    dtype=torch.float32, mc_seed=QMC_SEED).reshape(1, STEPS, -1)
    ys = [s.clone().requires_grad_(True) for s in scalars]
    logx = torch.zeros((1, ROWS * COLS), device=device) + ys[0][:, None]
    scan = torch.zeros_like(logx)
    for t in range(STEPS):
        logx = (logx + ys[1][:, None]) + ys[2][:, None] * eff[:, t]
        scan = scan + logx
    want = torch.autograd.grad(loss(scan), ys)
    rel = max(float(((g - w).abs() / w.abs()).max()) for g, w in zip(got, want))
    if rel > 1e-4:
        raise AssertionError(f"greeks: walk_acc's gradient misses autograd through the scan "
                             f"by {rel:.3e}")
    fwd_ms = cuda_ms(lambda: qmc_cuda.walk_acc_launch(
        directions, shift, bridge, 0, *scalars, timesteps=STEPS, count=ROWS * COLS))
    before = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"]
    acc = qmc_cuda.walk_acc(directions, shift, bridge, 0, *xs, timesteps=STEPS,
                            count=ROWS * COLS)
    cot = torch.full_like(acc, 1.0 / acc.numel())
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(acc, xs, grad_outputs=cot, retain_graph=True))
    if gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"] - before != 1 + 12:
        raise AssertionError("greeks: walk_acc's backward is not one launch of #14")
    phase("greeks", case="sobol-bb-geometric-call", engine=mc.engine.value, launches=n,
          price=round(mc.price, 5), oracle=round(oracle.price, 5), delta=round(mc.delta, 5),
          vega=round(mc.vega, 4), worst_rel_miss=f"{worst:.3e}",
          walk_grad_max_rel_vs_scan=f"{rel:.3e}")
    phase("greeks-backward", kernel="qmc_walk", shape=f"1x{ROWS}x{COLS}x{STEPS}",
          forward_ms=round(fwd_ms, 4), backward_ms=round(bwd_ms, 4))
    return {"launches": n, "forward_ms": fwd_ms, "backward_ms": bwd_ms}


def barrier_legs(device: torch.device, sim: SimulationParams,
                 contracts: torch.Tensor) -> torch.Tensor:
    """Per-path discounted call payoffs ``[C, paths]`` of a barrier sim on the
    threefry engine, all contracts on draw ``skip``'s key words."""
    simulate = make_underlier_simulator(sim, rows=ROWS)
    keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), sim.skip).expand(contracts.shape[0], 2)
    with torch.no_grad():
        rows = simulate(keys, contracts).reshape(contracts.shape[0], -1)
        return terminal_to_prices(rows, contracts, normalize=False,
                                  dtype=torch.float32).call_payoffs


def greeks_barrier(device: torch.device) -> None:
    """bump_greeks on an up-and-out call and knock_in_price on "xla" (both
    legs one threefry stream), each within 4 SE of the discrete-barrier
    oracle's same difference (its lattice error, by halving, in quadrature);
    the per-path legs computed here reproduce the estimators' values."""
    sim = greeks_sim("xla", payoff="barrier_up_out", barrier_rel=GREEKS_BARRIER_REL,
                     normalization="none")
    c = BlackScholesContract(**GREEKS_CONTRACT)
    s0 = c.spot
    h = 1e-2 * s0
    (bump, ms) = host_ms(lambda: greeks.bump_greeks(sim, c, device=device))
    (knock_in, ki_ms) = host_ms(lambda: greeks.knock_in_price(sim, c, device=device))
    base = c.as_array(torch.float32, device)
    spots = torch.stack([base, base + torch.tensor([h, 0, 0, 0, 0, 0], device=device),
                         base - torch.tensor([h, 0, 0, 0, 0, 0], device=device)])
    pays = barrier_legs(device, sim, spots).double()
    delta_paths = (pays[1] - pays[2]) / (2.0 * h)
    vanilla_sim = sim.model_copy(update={"payoff": PayoffKind.TERMINAL, "barrier_rel": None})
    simulate = make_underlier_simulator(vanilla_sim, rows=ROWS)
    keys = rng.fold_in(rng.prng_key(sim.mc_seed, device), sim.skip).reshape(1, 2)
    with torch.no_grad():
        terminal = simulate(keys, base[None]).reshape(1, -1)
        vanilla = terminal_to_prices(terminal, base[None], normalize=False,
                                     dtype=torch.float32).call_payoffs[0].double()
    in_paths = vanilla - pays[0]
    for name, got, mean in (("price", bump.price, float(pays[0].mean())),
                            ("delta", bump.delta, float(delta_paths.mean())),
                            ("knock_in", knock_in, float(in_paths.mean()))):
        if abs(got - mean) > 1e-4 * abs(mean) + 1e-6:
            raise AssertionError(f"greeks: {name} {got} is not its per-path legs' {mean}")

    def oracle(spot: float, grid: int) -> float:
        return float(analytic.discrete_barrier_price(
            spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol, timesteps=STEPS,
            barrier_rel=GREEKS_BARRIER_REL, up=True, grid_points=grid).call)

    fine = {s: oracle(s, GREEKS_BARRIER_GRID) for s in (s0, s0 + h, s0 - h)}
    coarse = {s: oracle(s, GREEKS_BARRIER_GRID // 2 + 1) for s in (s0, s0 + h, s0 - h)}
    want_delta = (fine[s0 + h] - fine[s0 - h]) / (2.0 * h)
    err_delta = abs(want_delta - (coarse[s0 + h] - coarse[s0 - h]) / (2.0 * h))
    black_call = float(analytic.black_scholes_price(*GREEKS_CONTRACT.values()).call)
    se = {name: float(x.std() / math.sqrt(x.numel()))
          for name, x in (("price", pays[0]), ("delta", delta_paths), ("knock_in", in_paths))}
    zs = {
        "price": z_score(bump.price, se["price"], fine[s0], abs(fine[s0] - coarse[s0])),
        "delta": z_score(bump.delta, se["delta"], want_delta, err_delta),
        "knock_in": z_score(knock_in, se["knock_in"], black_call - fine[s0],
                            abs(fine[s0] - coarse[s0])),
    }
    if max(zs.values()) > 4.0:
        raise AssertionError(f"greeks: barrier bump/knock-in z-scores {zs}")
    phase("greeks", case="barrier-bump-and-knock-in", engine="xla",
          price=round(bump.price, 5), oracle=round(fine[s0], 5), delta=round(bump.delta, 5),
          oracle_delta=round(want_delta, 5), knock_in=round(knock_in, 5),
          oracle_knock_in=round(black_call - fine[s0], 5),
          z={k: round(v, 3) for k, v in zs.items()}, bump_host_ms=round(ms, 3),
          knock_in_host_ms=round(ki_ms, 3))


def greeks_learned(device: torch.device, pricer: GbmCVNNPricer) -> None:
    """predict_greeks on the TERMINAL pricer of phases 4-6 at N = 1, 7, 64:
    prices equal to predict_price's bit for bit, call − put Jacobians equal
    to the parity term's gradient (rtol 1e-4 against the largest of the
    Jacobian columns), finite gammas, the host-clock p50 of 20 calls."""
    rows = held_out(PayoffKind.TERMINAL, 64)
    p50 = {}
    worst = 0.0
    for n in (1, 7, 64):
        batch = rows[:n]
        g = pricer.predict_greeks(batch)
        p = pricer.predict_price(batch)
        if not (np.array_equal(g.put, p.put) and np.array_equal(g.call, p.call)):
            raise AssertionError(f"greeks: predict_greeks prices are not predict_price's at N={n}")
        x = torch.from_numpy(batch).to(device).requires_grad_(True)
        parity = torch.exp(-x[:, 3] * x[:, 2]) * (
            make_mean_target(pricer.snapshot().sim)(x) - x[:, 1])
        (want,) = torch.autograd.grad(parity.sum(), x)
        want = want.cpu().numpy()
        gap = np.abs((g.call_jacobian - g.put_jacobian) - want)
        scale = np.maximum(np.abs(want), np.abs(g.put_jacobian)).max(axis=1, keepdims=True)
        if not np.all(gap <= 1e-4 * scale):
            raise AssertionError(f"greeks: Jacobian parity misses by {gap.max():.3g} at N={n}")
        worst = max(worst, float((gap / scale).max()))
        if not (np.all(np.isfinite(g.put_gamma)) and np.all(np.isfinite(g.call_gamma))):
            raise AssertionError(f"greeks: non-finite gammas at N={n}")
        times = []
        for _ in range(20):
            start = time.perf_counter()
            pricer.predict_greeks(batch)
            times.append((time.perf_counter() - start) * 1e3)
        p50[n] = statistics.median(times)
    phase("greeks", case="predict-greeks", pricer="terminal (phases 4-6)",
          prices_equal_predict_price=True, jacobian_parity_max_rel=f"{worst:.3e}",
          gamma_finite=True, p50_ms={k: round(v, 4) for k, v in p50.items()})


def backward_of(greeks_run: dict[str, dict], group: str) -> dict[str, object]:
    """The kernel record's ``backward`` entry for the three kernels with a
    backward rule (phase 29's CUDA ms at 1 x 2048 x 512 x 16), else none."""
    run = greeks_run.get(group)
    if run is None:
        return {}
    return {"backward": {"rule": BACKWARD_RULES[group], "ms": run["backward_ms"],
                         "forward_ms": run["forward_ms"], "shape": f"1x{ROWS}x{COLS}x{STEPS}"}}


BACKWARD_RULES = {
    "terminal": "gbm_cuda.TerminalPathwise (the pathwise rule over the kernel's samples)",
    "term_terminal": "gbm_cuda.TerminalPathwise with the curve's effective factors",
    "qmc_walk": "qmc_cuda.WalkAcc (the affine rule, B from a launch at (0, 0, 1))",
}


def phase_greeks(device: torch.device, smi: str, pricer: GbmCVNNPricer) -> dict[str, dict]:
    """Phase 29: the Greeks on the card at the production shape; returns, per
    kernel record (``terminal``, ``term_terminal``, ``qmc_walk``), the
    phase's main-path launches and the backward's and forward's CUDA ms."""
    start = time.perf_counter()
    parts: dict[str, float] = {}

    def timed(name: str, fn):
        begin = time.perf_counter()
        out = fn()
        parts[name] = round(time.perf_counter() - begin, 2)
        return out

    terminal = timed("terminal", lambda: greeks_terminal(device))
    term = timed("term", lambda: greeks_term(device))
    walk = timed("qmc", lambda: greeks_qmc(device))
    timed("barrier", lambda: greeks_barrier(device))
    timed("predict", lambda: greeks_learned(device, pricer))
    phase("greeks-done", seconds=round(time.perf_counter() - start, 2), parts_s=parts,
          nvidia_smi=repr(smi))
    return {"terminal": terminal, "term_terminal": term, "qmc_walk": walk}


def phase_profile(pricer: GbmCVNNPricer, label: str) -> None:
    _, seconds = train_steps(pricer, 10)
    cfg = build_training_config(
        num_batches=1, batch_size=BATCH, learning_rate=1e-3, contract_chunk=CHUNK
    ).expect("training config")
    wall, busy, launches, top = profiled(lambda: [pricer.train(cfg) for _ in range(3)])
    phase(f"profile-train{label}", warm_steps=len(seconds),
          median_step_s=f"{statistics.median(seconds):.4f}",
          min_step_s=f"{min(seconds):.4f}", max_step_s=f"{max(seconds):.4f}",
          profiled_steps=3, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", idle=f"{1 - busy / wall:.4f}", kernel_launches=launches,
          top=repr(top))
    sim = pricer.snapshot().sim
    rows = held_out(sim.payoff, 64, family_of(sim))
    for _ in range(5):
        pricer.predict_price(rows)
    wall, busy, launches, top = profiled(lambda: [pricer.predict_price(rows) for _ in range(20)])
    phase(f"profile-serve{label}", n=64, calls=20, wall_ms=f"{wall:.3f}", kernel_ms=f"{busy:.3f}",
          busy=f"{busy / wall:.4f}", kernel_launches_per_call=launches / 20, top=repr(top))


def phase_profile_heston_american(pricer: GbmCVNNPricer) -> None:
    """The Heston American put's step split three ways: 10 warm steps on the
    host clock, then 3 steps under torch.profiler (the monitor kernel's and
    the two-state backward kernel's device time, all kernels' device time)
    with the backward's span timed by CUDA events around each
    ``monitor_underliers`` call."""
    original = american_cuda.monitor_underliers
    spans: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def timed(*args: object, **kw: object) -> torch.Tensor:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kw)
        stop.record()
        spans.append((start, stop))
        return out

    _, seconds = train_steps(pricer, 10)
    cfg = build_training_config(
        num_batches=1, batch_size=BATCH, learning_rate=1e-3, contract_chunk=HESTON_AMERICAN_CHUNK
    ).expect("training config")
    american_cuda.monitor_underliers = timed
    try:
        (wall, busy, launches, top), moved = launched_by(
            lambda: profiled(lambda: [pricer.train(cfg) for _ in range(3)]))
    finally:
        american_cuda.monitor_underliers = original
    torch.cuda.synchronize()
    backward = sum(a.elapsed_time(b) for a, b in spans)
    monitor = sum(ms for name, _, ms in top if "american_heston_kernel" in name)
    kernel = sum(ms for name, _, ms in top if "backward_kernel" in name)
    phase("profile-train-heston-american", warm_steps=len(seconds),
          median_step_s=f"{statistics.median(seconds):.4f}", min_step_s=f"{min(seconds):.4f}",
          max_step_s=f"{max(seconds):.4f}", profiled_steps=3, wall_ms=f"{wall:.3f}",
          kernel_ms=f"{busy:.3f}", busy=f"{busy / wall:.4f}", kernel_launches=launches,
          monitor_kernel_ms=f"{monitor:.3f}", backward_kernel_ms=f"{kernel:.3f}",
          backward_span_ms=f"{backward:.3f}", backward_calls=len(spans),
          torch_estimator_calls=moved.get("torch_estimator", 0),
          rest_of_wall_ms=f"{wall - monitor - backward:.3f}",
          backward_share_of_wall=f"{backward / wall:.4f}", top=repr(top))
    rows = held_out(PayoffKind.AMERICAN_PUT, 64, "heston")
    for _ in range(5):
        pricer.predict_price(rows)
    wall, busy, launches, top = profiled(lambda: [pricer.predict_price(rows) for _ in range(20)])
    phase("profile-serve-heston-american", n=64, calls=20, wall_ms=f"{wall:.3f}",
          kernel_ms=f"{busy:.3f}", busy=f"{busy / wall:.4f}",
          kernel_launches_per_call=launches / 20, top=repr(top))


# --------------------------------------------------------------------------
# 30. sharded
# --------------------------------------------------------------------------

# (a): every kernel on the sharded path at the contracts its main path
# launches it with (the training chunk, or the batch-64 steps), by the
# engine's simulator: (label, simulation knobs, family, contracts)
OFFSET_CASES = [
    ("#1 terminal", dict(payoff="terminal"), "gbm", CHUNK),
    ("#1 terminal antithetic", dict(payoff="terminal", antithetic=True), "gbm", CHUNK),
    ("#1 asian", dict(payoff="asian_arithmetic"), "gbm", CHUNK),
    ("#1 asian_geometric antithetic", dict(payoff="asian_geometric", antithetic=True), "gbm",
     PAYOFF_BATCH),
    ("#1 barrier_up_out", dict(payoff="barrier_up_out", **KNOBS[PayoffKind.BARRIER_UP_OUT]),
     "gbm", PAYOFF_BATCH),
    ("#1 barrier_down_out antithetic", dict(payoff="barrier_down_out", antithetic=True,
                                            **KNOBS[PayoffKind.BARRIER_DOWN_OUT]),
     "gbm", PAYOFF_BATCH),
    ("#1 lookback_fixed_call", dict(payoff="lookback_fixed_call"), "gbm", PAYOFF_BATCH),
    ("#1 lookback_float_put antithetic", dict(payoff="lookback_float_put",
                                                 antithetic=True), "gbm", PAYOFF_BATCH),
    ("#1 variance_swap", dict(payoff="variance_swap"), "gbm", PAYOFF_BATCH),
    ("#1 digital", dict(payoff="digital"), "gbm", PAYOFF_BATCH),
    ("#1 forward_start", dict(payoff="forward_start", forward_start_step=FORWARD_STEP), "gbm",
     PAYOFF_BATCH),
    ("#1 euler terminal", dict(payoff="terminal", scheme="euler"), "gbm", PAYOFF_BATCH),
    ("#2 term", dict(payoff="terminal", term=term_of(STEPS)), "term", PAYOFF_BATCH),
    ("#2 term antithetic asian", dict(payoff="asian_arithmetic", antithetic=True,
                                      term=term_of(STEPS)), "term", PAYOFF_BATCH),
    ("#3 cliquet", dict(payoff="cliquet", **KNOBS[PayoffKind.CLIQUET]), "gbm", PAYOFF_BATCH),
    ("#3 cliquet antithetic", dict(payoff="cliquet", antithetic=True,
                                   **KNOBS[PayoffKind.CLIQUET]), "gbm", PAYOFF_BATCH),
    ("#5 heston", dict(payoff="terminal", model="heston"), "heston", CHUNK),
    ("#5 heston antithetic", dict(payoff="terminal", model="heston", antithetic=True),
     "heston", PAYOFF_BATCH),
    ("#7 basket", dict(payoff="terminal", model="basket_gbm", basket=BASKET_SPEC), "basket",
     CHUNK),
    ("#9 merton", dict(payoff="terminal", model="merton_jump"), "merton", PAYOFF_BATCH),
    ("#9 merton antithetic", dict(payoff="terminal", model="merton_jump", antithetic=True),
     "merton", PAYOFF_BATCH),
    ("#13 qmc_bridge F=2", dict(payoff="terminal", model="heston", sampling="sobol_bb",
                                mc_seed=QMC_SEED), "heston", PAYOFF_BATCH),
    ("#14 qmc_walk", dict(payoff="asian_geometric", sampling="sobol_bb", mc_seed=QMC_SEED),
     "gbm", CHUNK),
]
# the American monitor kernels: (label, model, basket spec, contracts)
MONITOR_OFFSET_CASES = [
    ("#4 american_gbm", ModelKind.GBM, None, CHUNK),
    ("#6 american_heston", ModelKind.HESTON, None, HESTON_AMERICAN_CHUNK),
    ("#8 american_basket", ModelKind.BASKET_GBM, BASKET_SPEC, PAYOFF_BATCH),
    ("#10 american_merton", ModelKind.MERTON_JUMP, None, PAYOFF_BATCH),
]
SHARD_WAYS = (2, 4)
SHARDED_MESH = (2, 2)  # (c): four gloo ranks on the one card
AMERICAN_MESH = (1, 2)  # (d): two ranks, the paths split
SHARDED_WARM_STEPS = 3
RANKS_TIMEOUT_S = 420.0
ONE_CARD = "several ranks on one card test the wiring, not scaling"


def shards_equal_full(run, rows_dim: int) -> tuple[int, int]:
    """``run(row_offset, rows)`` (a tuple of row tensors) at each shard of
    ``SHARD_WAYS`` against the full launch's rows, one shard at a time;
    ``(shards, launches)``."""
    before = gbm_cuda.LAUNCHES
    full = run(0, ROWS)
    shards = 0
    for ways in SHARD_WAYS:
        local = ROWS // ways
        for j in range(ways):
            part = run(j * local, local)
            for got, whole in zip(part, full, strict=True):
                if not torch.equal(got, whole.narrow(rows_dim, j * local, local)):
                    raise AssertionError(f"shard {j} of {ways} at row offset {j * local} "
                                         "differs from the full launch's rows")
            shards += 1
            del part
    del full
    return shards, gbm_cuda.LAUNCHES - before


def phase_sharded_offsets(device: torch.device) -> None:
    """30 (a): each kernel on the sharded path, split into 2 and 4 row shards
    at their offsets, bit-equal to its full launch's rows."""
    torch.cuda.empty_cache()
    for label, knobs, family, contracts in OFFSET_CASES:
        sim = build_simulation_params(
            timesteps=STEPS, network_size=COLS, batches_per_mc_run=ROWS, implementation="cuda",
            normalization="none", **{"mc_seed": 7, **knobs}).expect(label)
        params, keys = kernel_inputs(device, contracts, 30, family)

        def run(offset: int, rows: int) -> tuple[torch.Tensor]:
            return (make_underlier_simulator(sim, rows=rows)(keys, params, row_offset=offset),)

        shards, launched = shards_equal_full(run, rows_dim=1)
        if launched != 1 + shards:
            raise AssertionError(f"{label}: {launched} kernel launches for {1 + shards} calls")
        phase("sharded-offsets", case=label, contracts=contracts, shape=f"{ROWS}x{COLS}x{STEPS}",
              ways=list(SHARD_WAYS), shards=shards, launches=launched, bit_equal=True)
    for label, model, spec, contracts in MONITOR_OFFSET_CASES:
        family = {ModelKind.GBM: "gbm", ModelKind.HESTON: "heston",
                  ModelKind.MERTON_JUMP: "merton", ModelKind.BASKET_GBM: "basket"}[model]
        params, keys = kernel_inputs(device, contracts, 30, family)

        def monitor(offset: int, rows: int) -> tuple[torch.Tensor, ...]:
            price, extra = american_cuda.american_rows_cuda(
                params, keys, model=model, spec=spec, timesteps=STEPS, rows=rows, cols=COLS,
                exercise_every=1, antithetic_half=ROWS // 2, row_offset=offset)
            return (price,) if extra is None else (price, extra)

        shards, launched = shards_equal_full(monitor, rows_dim=2)
        phase("sharded-offsets", case=label, contracts=contracts, antithetic=True,
              shape=f"{ROWS}x{COLS}x{STEPS}", ways=list(SHARD_WAYS), shards=shards,
              launches=launched, bit_equal=True)
        torch.cuda.empty_cache()


class AllReduceClock:
    """CUDA events around every ``torch.distributed.all_reduce`` while
    installed (the port's collectives call it through the module)."""

    def __init__(self) -> None:
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def __enter__(self) -> "AllReduceClock":
        import torch.distributed as dist

        self._dist, self._inner = dist, dist.all_reduce

        def timed(*args: object, **kwargs: object) -> object:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._inner(*args, **kwargs)
            stop.record()
            self.events.append((start, stop))
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc: object) -> None:
        self._dist.all_reduce = self._inner

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(start.elapsed_time(stop) for start, stop in self.events)


def sharded_steps(pricer: GbmCVNNPricer, n: int) -> tuple[list[float], list[float], list[float]]:
    """``n`` timed single-batch steps: losses, host seconds to a synchronised
    end, and the all-reduce ms of each (CUDA events)."""
    losses, seconds, reduce_ms = [], [], []
    for _ in range(n):
        with AllReduceClock() as clock:
            loss, [sec] = train_steps(pricer, 1)
        losses.append(float(loss[0]))
        seconds.append(sec)
        reduce_ms.append(clock.ms())
    return losses, seconds, reduce_ms


def state_digest(pricer: GbmCVNNPricer) -> str:
    """sha256 of a replica's weights, buffers, Adam moments and counters."""
    import hashlib

    snap = pricer.snapshot()
    digest = hashlib.sha256()
    opt = snap.optimizer_state
    for named in (snap.model_state, opt.mu, opt.nu):
        for key in sorted(named):
            digest.update(key.encode() + named[key].tobytes())
    digest.update(f"{snap.global_step} {snap.sobol_skip} {snap.sim.skip}".encode())
    return digest.hexdigest()


SPLIT_PAIRS = 5  # (b): alternating unsharded and sharded warm steps


def step_split(unsharded: GbmCVNNPricer, sharded: GbmCVNNPricer) -> dict[str, object]:
    """Where a sharded step's time goes beside the unsharded one's, both
    warm and on one card: ``SPLIT_PAIRS`` alternations of one unsharded and
    one sharded step (host clock, no CUDA events installed), then one of each
    under torch.profiler: the device's kernel ms, and the host ops whose self
    CPU ms differ most between the two."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_s, sharded_s = [], []
    for _ in range(SPLIT_PAIRS):
        plain_s += train_steps(unsharded, 1)[1]
        sharded_s += train_steps(sharded, 1)[1]
    cfg = build_training_config(num_batches=1, batch_size=BATCH, learning_rate=1e-3,
                                contract_chunk=CHUNK).expect("training config")
    host: dict[str, dict[str, float]] = {}
    device_ms: dict[str, float] = {}
    for label, pricer in (("unsharded", unsharded), ("sharded", sharded)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pricer.train(cfg)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        host[label] = {e.key: e.self_cpu_time_total / 1e3 for e in rows
                       if e.device_type == DeviceType.CPU}
        device_ms[label] = sum(e.self_device_time_total for e in rows
                               if e.device_type == DeviceType.CUDA) / 1e3
    keys = set(host["unsharded"]) | set(host["sharded"])
    diff = {k: host["sharded"].get(k, 0.0) - host["unsharded"].get(k, 0.0) for k in keys}
    top = sorted(diff, key=lambda k: -abs(diff[k]))[:8]
    return {
        "unsharded_step_s": plain_s, "sharded_step_s": sharded_s,
        "unsharded_warm_step_s": statistics.median(plain_s),
        "sharded_warm_step_s": statistics.median(sharded_s),
        "profiled_host_ms": {k: round(sum(v.values()), 3) for k, v in host.items()},
        "profiled_device_ms": {k: round(v, 3) for k, v in device_ms.items()},
        "host_ms_sharded_minus_unsharded": [(k[:56], round(diff[k], 3)) for k in top],
    }


def phase_sharded_nccl(device: torch.device, smi: str, reference: np.ndarray,
                       unsharded: GbmCVNNPricer) -> tuple[int, dict[str, object]]:
    """30 (b): a (1, 1) mesh over nccl in this process, TERMINAL at the
    production configuration, against the unsharded run's losses; then its
    warm step beside the unsharded pricer's (``step_split``). The kernel #1
    launches of the sharded run's checked steps."""
    import socket

    from spectralmc_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )
    from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(coordinator_address=f"tcp://localhost:{port}", num_processes=1,
                           process_id=0, device_type="cuda", timeout_s=300.0).expect("nccl")
    try:
        spec = build_mesh_spec(batch_shards=1, paths_shards=1).expect("mesh")
        if spec.backend != "nccl":
            raise AssertionError(f"the (1, 1) mesh runs {spec.backend}, not nccl")
        gbm_cuda.reset_launches()  # the sharded path's count starts here
        pricer = GbmCVNNPricer.create(pricer_config(PayoffKind.TERMINAL), device=device,
                                      mesh_spec=spec).expect("sharded")
        losses, seconds, reduce_ms = sharded_steps(pricer, 1 + SHARDED_WARM_STEPS)
        launched = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"]
        split = step_split(unsharded, pricer)
    finally:
        shutdown_distributed()
    gap = float(np.max(np.abs(np.asarray(losses) / reference - 1.0)))
    if gap > 1e-6 or launched != len(losses) * BATCH // CHUNK:
        raise AssertionError(f"nccl (1, 1): losses {losses} vs {reference.tolist()} "
                             f"(gap {gap:.3e}), {launched} launches of #1")
    warm = statistics.median(seconds[1:])
    phase("sharded-nccl", mesh="(1, 1)", backend="nccl", world=1, losses=losses,
          unsharded=reference.tolist(), max_rel_gap=f"{gap:.3e}",
          bit_equal=bool(np.array_equal(np.asarray(losses, np.float32), reference)),
          launches=launched, warm_step_s=f"{warm:.4f}",
          allreduce_ms_per_step=f"{statistics.median(reduce_ms[1:]):.4f}", card=repr(smi))
    phase("sharded-nccl-split", mesh="(1, 1)", backend="nccl", pairs=SPLIT_PAIRS,
          clocked_warm_step_s=f"{warm:.4f}", **{
              k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in split.items()},
          card=repr(smi))
    return launched, {"warm_step_s": warm, "unsharded_warm_step_s": split["unsharded_warm_step_s"]}


def sharded_rank(rank: int, world: int, job: str, root: str, spawned_at: float) -> None:
    """One rank of phase 30 (c) or (d), in a spawned process on card 0: join
    a gloo world of ``world`` ranks, train on the job's mesh and write
    ``root/rank{rank}.json``."""
    from spectralmc_tpu_torch.parallel.distributed import (
        coordinator_only,
        initialize_distributed,
        shutdown_distributed,
    )
    from spectralmc_tpu_torch.parallel.mesh import build_mesh_spec

    torch.cuda.set_device(0)
    get_torch_handle()  # the parent's deterministic numerics policy
    device = torch.device("cuda", 0)
    initialize_distributed(coordinator_address=f"file://{root}/rendezvous",
                           num_processes=world, process_id=rank, device_type="cuda",
                           backend="gloo", timeout_s=300.0).expect("join")
    joined = time.time() - spawned_at
    shape = SHARDED_MESH if job == "terminal" else AMERICAN_MESH
    spec = build_mesh_spec(batch_shards=shape[0], paths_shards=shape[1]).expect("mesh")
    out: dict[str, object] = {"startup_s": joined}
    gbm_cuda.reset_launches()  # the sharded path's count starts here
    if job == "terminal":
        pricer = GbmCVNNPricer.create(pricer_config(PayoffKind.TERMINAL), device=device,
                                      mesh_spec=spec).expect("sharded")
        store = AsyncBlockchainModelStore(FileSystemObjectStore(f"{root}/store", "sharded"))
        cfg = build_training_config(num_batches=4, batch_size=BATCH, learning_rate=1e-3,
                                    contract_chunk=CHUNK).expect("training config")
        result = pricer.train(cfg, commit_plan=FinalAndIntervalCommit(interval=2),
                              commit_fn=coordinator_only(make_commit_fn(store))).expect("train")
        out["losses"] = [float(x) for x in result.losses]
        if rank == 0:
            served = pricer.predict_price(held_out(PayoffKind.TERMINAL, 7))
            out["served_put"] = served.put.tolist()
        _, seconds, reduce_ms = sharded_steps(pricer, SHARDED_WARM_STEPS)
        out.update(warm_step_s=statistics.median(seconds),
                   allreduce_ms=statistics.median(reduce_ms))
    else:
        pricer = GbmCVNNPricer.create(american_config(lsmc_fused_backward=False), device=device,
                                      mesh_spec=spec).expect("sharded american")
        losses, seconds, reduce_ms = sharded_steps(pricer, 3)
        out.update(losses=losses, warm_step_s=statistics.median(seconds[1:]),
                   allreduce_ms=statistics.median(reduce_ms[1:]),
                   lsmc_backward_version=pricer.snapshot().lsmc_backward_version)
    out["launches"] = dict(gbm_cuda.LAUNCHES_BY_BRANCH)
    out["state"] = state_digest(pricer)
    Path(root, f"rank{rank}.json").write_text(json.dumps(out))
    shutdown_distributed()


def run_ranks(job: str, world: int) -> list[dict[str, object]]:
    """Spawn ``world`` ranks of ``job`` (the kernel libraries are built
    already, so no rank runs nvcc) and wait for them; a rank that fails or
    outlives ``RANKS_TIMEOUT_S`` fails the phase, and every rank is stopped."""
    import multiprocessing

    torch.cuda.empty_cache()  # the ranks share this card
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        spawned_at = time.time()
        procs = [ctx.Process(target=sharded_rank, args=(r, world, job, root, spawned_at))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            for proc in procs:
                proc.join(timeout=max(deadline - time.monotonic(), 0.1))
                if proc.exitcode != 0:
                    break
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        if any(code != 0 for code in codes):
            raise AssertionError(f"sharded {job}: rank exit codes {codes}")
        runs = [json.loads(Path(root, f"rank{r}.json").read_text()) for r in range(world)]
        if job == "terminal":
            runs[0]["chain"] = chain_served(Path(root, "store"))
        return runs


def chain_served(root: Path) -> dict[str, object]:
    """The sharded run's chain: verified, and its head's put prices on the
    held-out contracts through ``InferenceClient``."""
    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(root), "sharded"))
    verdict = asyncio.run(verify_chain_detailed(store)).expect("verify")
    loaded, _ = load_served(store, TrackingMode())
    served = GbmCVNNPricer.create(loaded.config, device=torch.device("cuda", 0)).expect("served")
    return {"verdict": verdict, "counter": loaded.version.counter,
            "global_step": loaded.config.global_step,
            "put": served.predict_price(held_out(PayoffKind.TERMINAL, 7)).put.tolist()}


def phase_sharded(device: torch.device, smi: str) -> dict[str, int]:
    """Phase 30: (a) the kernels at row offsets; (b) nccl at world 1; (c)
    four gloo ranks on a (2, 2) mesh; (d) two ranks on a (1, 2) mesh with
    the American put. The launches of #1 and #4 on the sharded path."""
    phase_sharded_offsets(device)
    reference_pricer = GbmCVNNPricer.create(pricer_config(PayoffKind.TERMINAL),
                                            device=device).expect("unsharded")
    reference, _ = train_steps(reference_pricer, 1 + SHARDED_WARM_STEPS)
    launches = {"terminal": 0, "american_gbm": 0}
    launches["terminal"], nccl = phase_sharded_nccl(device, smi, reference, reference_pricer)
    del reference_pricer

    start = time.perf_counter()
    ranks = run_ranks("terminal", SHARDED_MESH[0] * SHARDED_MESH[1])
    call_s = time.perf_counter() - start
    losses = np.asarray(ranks[0]["losses"])
    gap = float(np.max(np.abs(losses / reference[:4] - 1.0)))
    chain = ranks[0]["chain"]
    if gap > 2e-4 or any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"gloo (2, 2): losses {[r['losses'] for r in ranks]} vs "
                             f"{reference.tolist()} (gap {gap:.3e})")
    if len({r["state"] for r in ranks}) != 1:
        raise AssertionError("gloo (2, 2): the replicas' state dicts differ between ranks")
    if (chain["verdict"], chain["counter"], chain["global_step"]) != (ChainValid(versions=2), 1,
                                                                     4):
        raise AssertionError(f"gloo (2, 2): the chain is {chain}")
    if chain["put"] != ranks[0]["served_put"]:
        raise AssertionError("gloo (2, 2): InferenceClient serves other prices than rank 0")
    terminal = [r["launches"]["terminal"] for r in ranks]
    if set(terminal) != {4 + SHARDED_WARM_STEPS}:  # one chunk of the shard's 256 a step
        raise AssertionError(f"gloo (2, 2): kernel #1 launches by rank {terminal}")
    launches["terminal"] += sum(terminal)
    phase("sharded-gloo", mesh=str(SHARDED_MESH), backend="gloo", world=len(ranks),
          device="cuda:0 (all ranks)", losses=losses.tolist(),
          unsharded=reference[:4].tolist(), max_rel_gap=f"{gap:.3e}", replicas_bit_equal=True,
          commits="rank 0 only: steps 2, 4", chain=repr(chain["verdict"]),
          served_bit_equal=True, launches_by_rank=terminal,
          warm_step_s=f"{statistics.median(r['warm_step_s'] for r in ranks):.4f}",
          allreduce_ms_per_step=f"{statistics.median(r['allreduce_ms'] for r in ranks):.4f}",
          rank_startup_s=[round(r["startup_s"], 2) for r in ranks],
          phase_s=f"{call_s:.1f}", nccl_warm_step_s=f"{nccl['warm_step_s']:.4f}",
          unsharded_warm_step_s=f"{nccl['unsharded_warm_step_s']:.4f}",
          note=ONE_CARD, card=repr(smi))

    american_pricer = GbmCVNNPricer.create(american_config(lsmc_fused_backward=False),
                                           device=device).expect("american unsharded")
    single, single_s = train_steps(american_pricer, 3)
    single_version = american_pricer.snapshot().lsmc_backward_version
    del american_pricer
    start = time.perf_counter()
    ranks = run_ranks("american", AMERICAN_MESH[0] * AMERICAN_MESH[1])
    call_s = time.perf_counter() - start
    losses = np.asarray(ranks[0]["losses"])
    gap = float(np.max(np.abs(losses / single - 1.0)))
    versions = [r["lsmc_backward_version"] for r in ranks]
    estimator = [r["launches"]["torch_estimator"] for r in ranks]
    monitor = [r["launches"]["american_gbm"] for r in ranks]
    if gap > 5e-3 or set(versions) != {0} or len({r["state"] for r in ranks}) != 1:
        raise AssertionError(f"gloo (1, 2) american: gap {gap:.3e}, backward versions "
                             f"{versions}, states {[r['state'] for r in ranks]}")
    if min(monitor) == 0 or set(estimator) != set(monitor) or any(
            r["launches"]["lsmc_backward"] for r in ranks):
        raise AssertionError(f"gloo (1, 2) american: launches {[r['launches'] for r in ranks]}")
    launches["american_gbm"] = sum(monitor)
    phase("sharded-american", mesh=str(AMERICAN_MESH), backend="gloo", world=len(ranks),
          lsmc_backward_version=0, single_process_backward=single_version,
          losses=losses.tolist(), single_process=single.tolist(), max_rel_gap=f"{gap:.3e}",
          single_process_warm_step_s=f"{statistics.median(single_s[1:]):.4f}",
          gate=5e-3, replicas_bit_equal=True, monitor_launches_by_rank=monitor,
          torch_estimator_by_rank=estimator,
          warm_step_s=f"{statistics.median(r['warm_step_s'] for r in ranks):.4f}",
          allreduce_ms_per_step=f"{statistics.median(r['allreduce_ms'] for r in ranks):.4f}",
          rank_startup_s=[round(r["startup_s"], 2) for r in ranks], phase_s=f"{call_s:.1f}",
          note=ONE_CARD, card=repr(smi))
    return launches


# Phase 31: the user entry points around the package. Each example's gate is
# the one this script holds that quantity to elsewhere; the trained models'
# puts (02, 07, 12) are held to the verify skill's convergence figures for a
# 600-batch run: the canonical GBM pricer within ~2-3% of Black (3%), a
# probe at the centre of its bounds within ~3-5% (5%).
EXAMPLES = Path(__file__).resolve().parent / "examples" / "torch"
EXAMPLE_KERNELS = {  # example -> the kernel branches its run launches on the card
    "01": ("terminal",), "02": ("terminal",), "03": (), "04": ("terminal",),
    "05": ("terminal",), "06": ("terminal",), "07": ("heston_terminal",), "08": ("terminal",),
    "09": ("terminal",), "10": ("basket_terminal",), "11": ("american_gbm", "lsmc_backward"),
    "12": ("merton_terminal",), "13": ("term_terminal",),
}
TRAINED_PUT_REL = {"02": 0.03, "07": 0.05, "12": 0.05}
SHARDED_EXAMPLE_RTOL = 2e-4  # phase 30 (c)'s gate on gloo ranks sharing the card


def load_example(path: Path) -> object:
    spec = importlib.util.spec_from_file_location(f"torch_example_{path.stem}", path)
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_gate(name: str, out: dict[str, object]) -> dict[str, object]:
    """Hold example ``name``'s returned numbers to its gate; what it printed
    against what, for the phase's line."""
    def fail(what: str) -> None:
        raise AssertionError(f"example {name}: {what}")

    if name == "01":
        zs = [z_score(out[side], out[f"{side}_se"], out[f"analytic_{side}"], 0.0)
              for side in ("put", "call")]
        if max(zs) > 4.0 or out["skip"] != 1:
            fail(f"z {zs} against Black, skip {out['skip']}")
        return {"z_put_call": [round(z, 3) for z in zs], "gate": "4 SE"}
    if name in TRAINED_PUT_REL:
        got = np.asarray(out["put"], dtype=float)
        want = np.asarray(out["analytic_put" if name == "02" else "exact_put"], dtype=float)
        rel = np.abs(got / want - 1.0)
        if not np.all(np.isfinite(out["losses"])) or rel.max() > TRAINED_PUT_REL[name]:
            fail(f"puts {got} against {want}")
        return {"puts": np.round(got, 4).tolist(), "oracle": np.round(want, 4).tolist(),
                "max_rel_err": f"{rel.max():.4f}", "gate": TRAINED_PUT_REL[name]}
    if name == "03":
        if out["verdict"] != ChainValid(versions=3) or out["tampered"] != "Failure" \
                or not isinstance(out["tampered_error"], StoreChecksumError):
            fail(f"chain {out['verdict']}, tampered load {out['tampered_error']!r}")
        return {"chain": repr(out["verdict"]), "tampered": type(out["tampered_error"]).__name__}
    if name == "04":
        if not out["resume_equal"] or len(out["versions"]) != 3:
            fail(f"resume {out['continued']} vs {out['resumed']}, versions {out['versions']}")
        return {"commits": [m.split()[0] for _, m in out["versions"]], "resume_bit_equal": True}
    if name == "05":
        if (out["pinned_bytes"], out["tracked_bytes"]) != (out["v0_bytes"], out["v1_bytes"]) \
                or not out["served_put"] == out["columnar_put"] == out["trainer_put"]:
            fail("the clients served other bytes or prices than were committed")
        return {"served": [out["pinned"], out["tracking_swapped"]],
                "bytes_bit_equal": True, "served_put": out["served_put"]}
    if name == "06":
        if not out["replicas_equal"] or out["max_rel_diff"] > SHARDED_EXAMPLE_RTOL:
            fail(f"sharded gap {out['max_rel_diff']}, replicas equal {out['replicas_equal']}")
        return {"mesh": str(out["mesh"]), "backend": out["backend"],
                "devices": out["devices"], "max_rel_diff": f"{out['max_rel_diff']:.3e}",
                "gate": SHARDED_EXAMPLE_RTOL}
    if name == "08":
        coordinators = [r["is_coordinator"] for r in out["ranks"]]
        if not out["replicas_equal"] or out["verdict"] != ChainValid(versions=1) \
                or coordinators != [True, False]:
            fail(f"chain {out['verdict']}, replicas {out['replicas_equal']}, {coordinators}")
        return {"mesh": out["ranks"][0]["mesh"], "backend": out["backend"],
                "devices": out["devices"], "commits": "rank 0 only",
                "chain": repr(out["verdict"])}
    if name == "09":
        mc, oracle = out["mc"], out["oracle"]
        worst = check_greeks("example 09", mc, oracle.price,
                             {f: oracle.by_field[f] for f in GREEKS_FIELDS}, rel=0.02,
                             floor=0.01, price_abs=0.01)
        gamma_miss = abs(mc.gamma - oracle.gamma) / oracle.gamma
        if gamma_miss > 0.05 or mc.engine != SimImplementation.CUDA:
            fail(f"gamma {mc.gamma} vs {oracle.gamma} on {mc.engine}")
        return {"engine": mc.engine.value, "worst_rel_miss": f"{worst:.3e}",
                "gamma_rel_miss": f"{gamma_miss:.3e}", "gate": "2%, gamma 5%"}
    if name == "10":
        z = z_score(out["geo_call"], out["geo_se"], out["geo_closed_form"], 0.0)
        calls = out["arithmetic_call"]
        if z > 4.0 or not calls[0] < calls[1] < calls[2]:
            fail(f"geometric z {z}, arithmetic calls by correlation {calls}")
        return {"geometric_z": round(z, 3), "gate": "4 SE", "arithmetic_calls": calls}
    if name == "11":
        lsmc, bracket, tree = out["lsmc"], out["bracket"], out["tree"]
        slack = 4 * bracket.std_error
        if abs(lsmc.price - tree) > max(4 * lsmc.std_error, 0.005 * tree) \
                or not bracket.price - slack <= tree <= bracket.in_sample_price + slack \
                or (out["engine"], out["lsmc_backward_version"]) != (
                    "cuda", american_cuda.LSMC_BACKWARD_VERSIONS["cuda"]):
            fail(f"LSMC {lsmc}, bracket {bracket}, tree {tree}, engine {out['engine']} "
                 f"v{out['lsmc_backward_version']}")
        return {"lsmc": round(lsmc.price, 4), "se": round(lsmc.std_error, 4),
                "tree": round(tree, 4), "bracket": [round(bracket.price, 4),
                                                    round(bracket.in_sample_price, 4)],
                "gate": "max(4 SE, 0.5%); bracket within 4 SE",
                "lsmc_backward_version": out["lsmc_backward_version"]}
    if name == "13":
        rel = abs(out["put"] / out["effective_black_put"] - 1.0)
        if rel > 0.04 or out["greeks"].engine != SimImplementation.CUDA:
            fail(f"curved put {out['put']} vs {out['effective_black_put']}")
        return {"put": round(out["put"], 4), "effective_black": round(
            out["effective_black_put"], 4), "rel_err": f"{rel:.4f}", "gate": 0.04}
    raise AssertionError(f"example {name} has no gate")


def phase_examples(device: torch.device, smi: str) -> dict[str, int]:
    """Phase 31 (a): each of examples/torch/01-13 on the card at its own
    sizes, through ``run``, against its gate; the kernel branches it launched
    (the ranks' own counts for 06 and 08), each expected one at least once."""
    launches: dict[str, int] = {}
    paths = sorted(EXAMPLES.glob("[0-9]*.py"))
    if [p.name[:2] for p in paths] != sorted(EXAMPLE_KERNELS):
        raise AssertionError(f"examples/torch holds {[p.name for p in paths]}")
    for path in paths:
        name = path.name[:2]
        module = load_example(path)
        gbm_cuda.reset_launches()  # this example's count starts here
        start = time.perf_counter()
        out = module.run(device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launched = {b: n for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n}
        for branch, n in out.get("rank_launches", {}).items():
            launched[branch] = launched.get(branch, 0) + n
        missing = [b for b in EXAMPLE_KERNELS[name] if not launched.get(b)]
        if missing:
            raise AssertionError(f"example {path.stem} launched no {missing} kernel")
        phase("example", example=path.stem, seconds=f"{seconds:.2f}", launches=launched,
              **example_gate(name, out), card=repr(smi))
        for branch, n in launched.items():
            launches[branch] = launches.get(branch, 0) + n
    return launches


CHECKED_PRICERS = (  # label, config, recorded engine, backward version, kernels launched
    ("terminal", lambda: pricer_config(PayoffKind.TERMINAL), "cuda", 0, ("terminal",)),
    ("qmc-asian", lambda: pricer_config(PayoffKind.ASIAN_GEOMETRIC, sampling="sobol_bb"),
     "xla", 0, ("qmc_walk",)),
    ("american", american_config, "cuda", american_cuda.LSMC_BACKWARD_VERSIONS["cuda"],
     ("american_gbm", "lsmc_backward")),
    ("heston-american", american_dynamics_config, "cuda",
     american_cuda.LSMC_BACKWARD_VERSIONS["cuda_two_state"],
     ("american_heston", "lsmc_two_state")),
)
CHECK_BATCHES = 4
FLOAT64_STEP_LIMIT_S = 2.0
# a float64 threefry step at the full 2048 rows takes over a minute on the
# card (PERF.md), so the halving of its rows starts at 64
FLOAT64_START_ROWS = 64
FLOAT64_CPU_RTOL = 1e-9


def checked(label: str, base: GbmCVNNPricerConfig, engine: str, backward: int,
            kernels: tuple[str, ...], device: torch.device, smi: str,
            **line: object) -> dict[str, int]:
    """The model checker on ``base`` at the production batch: 0 violations
    over every split schedule of CHECK_BATCHES, the recorded engine and
    backward, the kernels launched."""
    gbm_cuda.reset_launches()  # the checker's count starts here
    report = torch_model_check.run_model_check(
        base, CHECK_BATCHES, device=device, label=f"[model-check] {label}",
        training=torch_model_check.Training(batch_size=BATCH, contract_chunk=CHUNK))
    launched = {b: n for b, n in gbm_cuda.LAUNCHES_BY_BRANCH.items() if n}
    if report.violations or (report.implementation, report.lsmc_backward_version) != (
            engine, backward) or not all(launched.get(k) for k in kernels):
        raise AssertionError(f"model check {label}: {report}, launches {launched}")
    phase("model-check", pricer=label, schedules=report.schedules + 1,
          split_schedules=report.schedules, violations=0, engine=report.implementation,
          stream_version=report.cuda_stream_version,
          lsmc_backward_version=report.lsmc_backward_version, launches=launched,
          seconds=f"{report.seconds:.1f}", **line, card=repr(smi))
    return launched


def float64_card_vs_cpu(device: torch.device, smi: str) -> None:
    """Phase 31 (c), first part: the float64 threefry TERMINAL pricer at a
    small size, 3 steps on the card and on the CPU from the same weights,
    losses within rtol 1e-9."""
    sim = build_simulation_params(timesteps=4, network_size=64, batches_per_mc_run=64,
                                  mc_seed=7, implementation="xla",
                                  precision="float64").expect("float64 sim")
    config = GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, normalize_inputs=True,
                                 cvnn=torch_model_check.production_cvnn(Precision.float64))
    cfg = build_training_config(num_batches=3, batch_size=8, learning_rate=1e-3).expect("cfg")
    card = GbmCVNNPricer.create(config, device=device).expect("card").train(cfg).expect("t")
    cpu = GbmCVNNPricer.create(config, device="cpu").expect("cpu").train(cfg).expect("t")
    gap = float(np.max(np.abs(card.losses / cpu.losses - 1.0)))
    if gap > FLOAT64_CPU_RTOL:
        raise AssertionError(f"float64: card losses {card.losses} vs CPU {cpu.losses}")
    phase("float64-card-vs-cpu", engine="xla", precision="float64",
          shape="8 contracts x 64 x 64 paths x 4 steps", card=card.losses.tolist(),
          cpu=cpu.losses.tolist(), max_rel_gap=f"{gap:.3e}", gate=FLOAT64_CPU_RTOL,
          bit_equal=bool(np.array_equal(card.losses, cpu.losses)), nvidia_smi=repr(smi))


def phase_entry_points(device: torch.device, smi: str) -> dict[str, int]:
    """Phase 31: (a) the examples, (b) the model checker at the production
    batch for four pricers, (c) the float64 threefry engine. The kernel
    launches of its runs, by branch."""
    start = time.perf_counter()
    launches = phase_examples(device, smi)
    for label, config, engine, backward, kernels in CHECKED_PRICERS:
        for branch, n in checked(label, config(), engine, backward, kernels, device,
                                 smi).items():
            launches[branch] = launches.get(branch, 0) + n
    float64_card_vs_cpu(device, smi)
    rows = FLOAT64_START_ROWS
    while True:
        base, training = torch_model_check.config_for("terminal_f64", full=True, rows=rows)
        pricer = GbmCVNNPricer.create(base, device=device).expect("float64")
        torch.cuda.synchronize()
        step = time.perf_counter()
        pricer.train(training.config(1)).expect("float64 step")
        torch.cuda.synchronize()
        step_s = time.perf_counter() - step
        del pricer
        if step_s <= FLOAT64_STEP_LIMIT_S:
            break
        rows //= 2
    checked("terminal-float64", base, "xla", 0, (), device, smi,
            rows_cut=f"{ROWS} -> {rows} rows a contract (a step under {FLOAT64_STEP_LIMIT_S} s)",
            step_s=f"{step_s:.3f}")
    phase("entry-points", seconds=f"{time.perf_counter() - start:.1f}", card=repr(smi))
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the checks, time warm train steps and profile train and serve")
    args = parser.parse_args()
    device, smi, max_sm_hz = phase_device()
    per_step, american_sass, dynamics_sass, lsmc_sass, qmc_sass = phase_build()
    kernel = phase_kernel(device, per_step, max_sm_hz)
    phase_oracle(device)
    phase_oracle_families(device)
    launches: dict[str, int] = {}
    gbm_cuda.reset_launches()  # the TERMINAL path's count starts here
    pricer = phase_train(device, PayoffKind.TERMINAL, "train")
    phase_resume(device, pricer, "resume")
    phase_serve(pricer, device, "serve")
    launches["terminal"] = gbm_cuda.LAUNCHES_BY_BRANCH["terminal"]
    gbm_cuda.reset_launches()  # the Asian path's count starts here
    asian = phase_train(device, PayoffKind.ASIAN_ARITHMETIC, "train-asian")
    phase_resume(device, asian, "resume-asian")
    phase_serve(asian, device, "serve-asian")
    launches["asian"] = gbm_cuda.LAUNCHES_BY_BRANCH["asian"]
    gbm_cuda.reset_launches()  # the other payoffs' path starts here
    phase_payoffs(device)
    for branch in ("barrier", "lookback", "variance", "cliquet"):
        launches[branch] = gbm_cuda.LAUNCHES_BY_BRANCH[branch]
    gbm_cuda.reset_launches()  # the Heston path's count starts here
    heston = phase_train(device, PayoffKind.TERMINAL, "train-heston", "heston")
    phase_resume(device, heston, "resume-heston")
    phase_serve(heston, device, "serve-heston")
    launches["heston_terminal"] = gbm_cuda.LAUNCHES_BY_BRANCH["heston_terminal"]
    gbm_cuda.reset_launches()  # the other family branches' path starts here
    phase_families(device)
    for group in TIMED:
        launches.setdefault(group, gbm_cuda.LAUNCHES_BY_BRANCH[group])
    kernel.update(phase_basket_kernel(device, per_step, max_sm_hz))
    kernel.update(phase_qmc_kernel(device, qmc_sass, max_sm_hz))
    phase_oracle_basket_qmc(device)
    gbm_cuda.reset_launches()  # the basket pricer's path starts here
    basket = phase_train(device, PayoffKind.TERMINAL, "train-basket", "basket")
    phase_resume(device, basket, "resume-basket")
    phase_serve(basket, device, "serve-basket")
    launches["basket_terminal"] = gbm_cuda.LAUNCHES_BY_BRANCH["basket_terminal"]
    gbm_cuda.reset_launches()  # the SOBOL_BB geometric-Asian pricer's path starts here
    qmc_asian = phase_train(device, PayoffKind.ASIAN_GEOMETRIC, "train-qmc-asian",
                            sampling="sobol_bb", group="qmc_walk")
    phase_resume(device, qmc_asian, "resume-qmc-asian")
    phase_serve(qmc_asian, device, "serve-qmc-asian")
    launches["qmc_walk"] = gbm_cuda.LAUNCHES_BY_BRANCH["qmc_walk"]
    gbm_cuda.reset_launches()  # the basket branches' and the generator's path starts here
    phase_basket_qmc_families(device)
    for group in (*BASKET_TIMED, "qmc_bridge"):
        launches.setdefault(group, gbm_cuda.LAUNCHES_BY_BRANCH[group])
    kernel.update(phase_kernel_american(device, american_sass, max_sm_hz))
    kernel.update(phase_kernel_lsmc(device, lsmc_sass, max_sm_hz))
    phase_oracle_american(device)
    gbm_cuda.reset_launches()  # the American pricer's path starts here
    american_pricer = phase_train_american(device)
    phase_resume(device, american_pricer, "resume-american")
    phase_serve(american_pricer, device, "serve-american")
    for group in ("american_gbm", "lsmc_backward"):
        launches[group] = gbm_cuda.LAUNCHES_BY_BRANCH[group]
    gbm_cuda.reset_launches()  # the American families' path starts here
    phase_families_american(device)
    launches["lsmc_backward_streamed"] = gbm_cuda.LAUNCHES_BY_BRANCH["lsmc_backward_streamed"]
    kernel.update(phase_kernel_american_dynamics(device, dynamics_sass, max_sm_hz))
    kernel.update(phase_backward_american_dynamics(device, lsmc_sass, max_sm_hz))
    phase_oracle_american_dynamics(device)
    gbm_cuda.reset_launches()  # the Heston American pricer's path starts here
    heston_american = phase_train_heston_american(device)
    phase_resume(device, heston_american, "resume-heston-american")
    phase_serve(heston_american, device, "serve-heston-american")
    for group in ("american_heston", "lsmc_two_state"):
        launches[group] = gbm_cuda.LAUNCHES_BY_BRANCH[group]
    gbm_cuda.reset_launches()  # the other dynamics' American pricers' path starts here
    phase_families_american_dynamics(device)
    for group in ("american_merton", "american_basket", "lsmc_two_state_streamed"):
        launches[group] = gbm_cuda.LAUNCHES_BY_BRANCH[group]
    missing = [b for b, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main paths never launched the {missing} kernel branches")
    for (label, groups, chunk), bytes_pricer in zip(BYTES_PRICERS,
                                                    (pricer, american_pricer, heston_american)):
        phase_checkpoint_store(device, smi, label, bytes_pricer, groups, chunk)
    phase_train_loop(device, smi, pricer.snapshot())
    gbm_cuda.reset_launches()  # the Greeks' path starts here
    greeks_run = phase_greeks(device, smi, pricer)
    for group, run in greeks_run.items():
        launches[group] += run["launches"]
    for group, n in phase_sharded(device, smi).items():
        launches[group] += n
    for group, n in phase_entry_points(device, smi).items():
        if group in launches:
            launches[group] += n
    if args.profile:
        phase_profile(pricer, "")
        phase_profile(asian, "-asian")
        phase_profile(heston, "-heston")
        phase_profile(basket, "-basket")
        phase_profile(qmc_asian, "-qmc-asian")
        phase_profile(american_pricer, "-american")
        phase_profile_heston_american(heston_american)
    records = []
    for group, (family, _, _) in TIMED.items():
        flat = family == "gbm"
        records.append({
            "name": f"gbm_{group}" if family in ("gbm", "term") else group,
            "route": "cuda",
            "source": SOURCE if flat else DYNAMICS_SOURCE,
            "replaces": (REPLACES.get(group, "spectralmc_tpu/ops/gbm_pallas.py:512") if flat
                         else FAMILY_REPLACES[family]),
            "launches": launches[group],
            "max_abs_err": kernel[group]["max_abs_err"],
            "ms": kernel[group]["ms"],
            "plain_ms": kernel[group]["plain_ms"],
            "bound_ms": kernel[group]["bound_ms"],
            "bound_by": kernel[group]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes these functions
            **backward_of(greeks_run, group),
        })
    for group in (*BASKET_TIMED, "qmc_bridge", "qmc_walk"):
        in_basket = group.startswith("basket_")
        records.append({
            "name": group,
            "route": "cuda",
            "source": BASKET_SOURCE if in_basket else QMC_SOURCE,
            "replaces": BASKET_REPLACES if in_basket else QMC_REPLACES[group],
            "launches": launches[group],
            **{k: kernel[group][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            "library_ms": None,  # no single PyTorch call computes these functions
            **backward_of(greeks_run, group),
        })
    records.append({
        "name": "american_gbm",
        "route": "cuda",
        "source": AMERICAN_SOURCE,
        "replaces": AMERICAN_REPLACES["american_gbm"],
        "launches": launches["american_gbm"],
        **{k: kernel["american_gbm"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by")},
        "library_ms": None,  # no single PyTorch call computes this function
    })
    for group, replaces in LSMC_REPLACES.items():
        two = group.startswith("lsmc_two_state")
        grid, slots = american_cuda.lsmc_plan(LSMC_DEGREE, two, True, device.index or 0)
        records.append({
            "name": group,
            "route": "cuda",
            "source": LSMC_SOURCE,
            "replaces": replaces,
            "launches": launches[group],
            **{k: kernel[group][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            "library_ms": None,  # no single PyTorch call computes these functions
            "split": (f"ops/american_cuda.py::lsmc_route: resident while ceil(paths / 4096) <= "
                      f"{grid * slots} ({grid} CTAs x {slots} on-chip tiles, degree "
                      f"{LSMC_DEGREE}), else streamed"),
        })
    for group, replaces in DYNAMICS_AMERICAN_REPLACES.items():
        records.append({
            "name": group,
            "route": "cuda",
            "source": DYNAMICS_AMERICAN_SOURCE,
            "replaces": replaces,
            "launches": launches[group],
            **{k: kernel[group][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            "library_ms": None,  # no single PyTorch call computes these functions
        })
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
