"""Smoke test of the PyTorch port on one CUDA card (run from the repo root):

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero
and the final ``{"ok": true, ...}`` line is not printed:

1. card: name and power limit (nvidia-smi); CUDA must be available; and
   which optional packages and tools the machine has (h5py, matplotlib,
   tqdm, psutil, Pillow; g++, zlib.h, ffmpeg): the writer named by
   ``SNAPSHOT_IO`` must be among them
2. build: compile the hand-written kernels with nvcc (sm_90a), one nvcc
   per source, all started together
3. kernel vs plain: the fused predictor against its plain torch version
   on every route of its plan (16-byte vectors at (48, 64), (1024, 1024),
   (4096, 4096) and (4, 8); 8-byte at (1000, 1030); 4-byte at (37, 129),
   (3, 3), (4, 5) and at (48, 64) on a base pointer that is only 4-byte
   aligned, a slice of a longer buffer); max |Δ| ≤ 1e-6 and the boundary
   frame bit-equal to the input; each line names its route. Then the
   RB-SOR kernels:
   kernel A (Neumann, Dirichlet, masked; 30 sweeps) on every route of its
   plan: a cluster of 1 at (32, 48), the problem of
   tests/test_pallas.py:12-28, of 2 at (37, 129), of 8 at (128, 256), of
   16 at (180, 600) with the cylinder's solid mask and (512, 512) (40
   sweeps: its bands take the cluster from 32), and the cooperative kernel
   above the cluster's capacity at (360, 1200) with the cylinder's mask
   and (768, 768); kernel B against kernel A and against
   its plain version on each load route: TMA at (64, 48) K=3, (72, 32) K=8
   and (1024, 1024) with a tail pass, cp.async at (1000, 1030) and (65,
   33); the early exit on each route (48², and a tol reached after 3
   chunks at 180×600 and 360×1200, and at 180×600 with a residual check
   after every sweep: the same chunk count as the plain version). Each
   line names its route. Band 1e-6 for A and
   5e-6 for B (the bands of tests/test_pallas.py) at every size: the
   kernels spell out every rounding, so they are expected to give the
   plain versions' bits, and each line says whether they do
4. chunk routes: 10 steps through the captured chunk (one CUDA graph,
   ``make_chunk``'s route on the card) against 10 eager step calls from
   the same state, metrics on, on the three paths below, on the
   implicit cavity (DST, and with LES the Jacobi back end), the LES
   cylinder and the coupled transport cavity of phases 9-12, on the
   twelve staggered cells of ``bench.mac_paths`` (phases 5c-5d, the three
   ghost-IBM cylinders included), the two 1024² heated cavities, the
   two 256³ cavities (5g-5h), the five full-width 3D bodies of 5i, the
   five 2D compressible cells and the 256³ blast of 5j and the four
   spectral cells of 5k (``bench.compressible_paths``,
   ``bench.spectral_paths``; the complex ω̂ included); the same kernels
   in the same order, so u, v, p, t, step (θ too) and every stacked metric
   must be bit-equal; prints the graph's nodes and capture seconds per path, and
   holds each kernel's launches, counted on the device by the kernel
   itself, to 10 per captured chunk plus the capture's eager warm-up
5. golden: the 48² Re=100 cavity, a 300-step captured chunk + one metrics
   step, fused predictor off and on, against tests/goldens.json (RTOL 2e-5)
5a. DCT variants: every variant against rfft at 1024² (rfft_split4 and
   rfft_split8 also at 4096²), max |Δφ| ≤ 1e-5 of max|φ|; ``"auto"`` at
   1024² in a cache directory of the run's own: the first build measures
   once, the second reads the in-process cache, a cleared process the file,
   a MAC cavity built with "auto" captures its chunk without timing, and a
   cache miss under a capture raises; then every variant's device ms at
   256², 512², 1024², 2048² and 4096² and each shape's winner
5b. FDM precision: with ``torch.set_float32_matmul_precision("high")`` set,
   the stretched 512² solve (``wall_clustered_faces``, β = 1.5) has
   ‖Lφ − rhs‖ / ‖rhs‖ ≤ 1e-4, and the setting reads "high" afterwards; the
   same four products without the guard are printed beside it
5c. staggered paths, each from rest through runner.Simulation's captured
   chunks, 200 steps: the 1024² Re=1000 MAC cavity (chorin, incremental,
   implicit), ``cylinder_mac`` at 720×240, ``cylinder_oscillating`` at
   480×240 uniform and stretched, ``cavity_stretched`` at 512² and
   ``cylinder_stretched`` at 512×256, and, with the ghost-cell IBM,
   ``cylinder_mac`` at 720×240 (static stencils) and the oscillating
   cylinder at 480×240, uniform and stretched (moving ghost forcing),
   their body forces printed: healthy, no kernel launched, and
   ``div_post`` at float32 roundoff in every step: ≤ 1e-5·max|u|/h (max|u|
   over the run) for the DCT projection, 1e-4 for the stretched tier's
   four float32 matmuls
5d. MAC kernels: the 1024² ``mg:2`` MAC cavity, 100 steps, launching
   kernels A and B as phase 8's cavity does (the same pressure grid), then
   5 steps against plain smoothing (u, v within 1e-5); ``cylinder_mac``
   with the kernel-A solve of phase 7 (``rbsor_pallas``), 50 steps, one
   launch per step
5e. MAC goldens: ``cavity_mac_48_re1000`` (300 steps) and
   ``cylinder_mac_forces`` (200) through the captured chunk, RTOL 2e-5
   (the second's fy at 2e-5 of |fx| and max_p at 1e-4, the bands of
   tests/test_torch_mac_cylinder.py)
5f. Botella–Peyret gate: the 128² Re=1000 MAC cavity to t = 200 in
   captured chunks of 2000 steps; the largest centreline-extremum error
   under 0.009 (tests/test_mac_accuracy_slow.py:25)
5g. Boussinesq: the golden ``heated_cavity_32`` (300 steps, RTOL 2e-5);
   the de Vahl Davis gate (48², Ra = 1e3, t = 0.6: Nu at the hot wall and
   the mid-plane within 2% of 1.118, the largest velocity within 5% of
   3.70); the onset bracket at ny = 32 (Ra = 1200 decays by t = 1, Ra =
   3000 convects by t = 5; tests/test_boussinesq.py:97-125); the 1024²
   heated cavity, Ra = 1e4, 100 steps through the DCT (no kernel,
   ``div_post`` at roundoff: 1e-5 of the larger of max|u| and dt·max|p|/h,
   over h, since from rest the projection subtracts the hydrostatic
   pressure) and through ``mg:2`` (kernels A and B
   launched as phase 8's cavity: the same pressure grid)
5h. 3D: ``cavity3d`` at 256³ through ``mg:2`` and ``cavity3d_mac`` at
   256³ through the ``rfftn`` DCT (BASELINE.json config 5's size), 100
   steps each: healthy, no kernel launched, the MAC one's ``div_post`` at
   roundoff (1e-5·max|u|/h); then ``run cavity3d_mac --n 128`` through the
   command line with native snapshots, 50 steps, ``--resume`` to 100,
   against one run of 100: bit-equal snapshots and restored states
5i. 3D bodies: the goldens ``sphere_ghost_ibm`` (``sphere_stretched``
   with ghost stencils, 60 steps at 36×20×20) and ``heated_sphere_nu``
   (``heated_sphere``, 60 steps at 32×16×16) through the captured chunk by
   the rule of tests/test_goldens.py; the drag gate:
   ``sphere_stretched(ibm_scheme="ghost")`` at its default 192×96×96
   (~30 cells/D near the body), Re = 100, to t = 40: Cd =
   ``coeff_scale``·fx within 2% of Schiller–Naumann's 1.092, |fy| and |fz|
   under 2% of fx; the heat gate: ``heated_cube(n=48, Ra=1e4)`` to t =
   0.4: the hot-wall Nu within 1% of Tric et al.'s 2.054, the wall and
   mid-plane Nu within 0.5% of each other, θ within [−1e-3, 1 + 1e-3];
   then each full-width body (``bench.sphere_paths``: ``sphere()`` at
   192×96×96, ``sphere_stretched`` with ghost stencils and dynamic LES at
   Re = 3900 (100 steps, its C_s² printed), ``heated_sphere_stretched`` with
   ghost stencils, ``cavity3d_stretched(n=128)`` and a moving ghost
   sphere) from its start through runner.Simulation: healthy, no kernel
   launched, its busy and wall ms per step, events per step, idle share,
   graph nodes and peak memory
5j. compressible: the goldens ``wedge_shock``, ``cavity_supersonic_pin``
   and ``cavity_supersonic_real`` (150 steps, RTOL 2e-5); the Sod star
   states at nx = 400, t = 0.2 within 3%; the θ-β-M gate: the wedge-aligned
   400×200 wedge, HLLC + MUSCL, to t = 2.5: β within 0.5° of 39.31°, ρ₂ and
   p₂ within 1% of 1.458 and 1.707, |v| < 0.01; the five 2D cells at the
   reference's sizes (the 400×200 wedge in its three modes, the 600×180
   cavity with 2 ghost layers, pinned and real), 300 steps each through
   runner.Simulation with the compressible health check, no kernel
   launched, then steps/s through the captured chunk (marginal 50-250
   steps; the cavity beside the reference's >100 steps/s); the blast's
   gates at 64³ (80 steps: mass and energy to 1e-4, the three axis
   profiles within 0.02), then its 256³ cell's steps/s and peak memory
5k. spectral: ``kolmogorov`` at 640×360, sl and bfecc, the reference's 750
   steps through runner.Simulation, and ``kolmogorov_ps`` at 512² and
   1024² (500 steps), each then timed (marginal 50-250 steps); the
   pseudo-spectral gates: the inviscid Taylor–Green energy at 96² over 500
   steps to 1e-4, the forced laminar profile at 64² (8000 steps, t = 16)
   within 5e-3 of fs/(νk²+α) with |v| under 1e-4 of it
5l. new tiers, snapshots and resume through the command line: ``run
   wedge --frame wedge_aligned`` (400×200) and ``run kolmogorov_ps --ny
   1024`` with native snapshots, 100 steps, ``--resume`` to 200, against
   one run of 200: bit-equal records and restored states; ω̂ is stored as
   the JAX package's float32 planes (2, 1024, 513)
5m. FEM (``phase_fem``): ``bench.fem_paths`` (``cylinder_fem(re=100,
   wake_refine=True)``, monolithic and projection) profiled over 3 steps
   on the loop route (their Krylov exits are read on the host): events,
   busy and wall ms per step, idle share, triangles, matvecs and host reads
   per step; twenty projection steps of the Schäfer–Turek case twice from
   its initial state, bit-equal; the Schäfer–Turek 2D-2 gate at the
   configuration of examples/schafer_turek_2d2.py (projection, ~10.7k
   triangles, θ = ½, dt = 0.002) to t = 12, the tail from t = 6 (t = 8 and
   4 where the first 250 steps say the run would take over 300 s): the
   tail's largest Cd in 3.22-3.24 (the benchmark's c_D,max) and its mean
   within 1% of the JAX package's 3.19 for the same window, the FFT
   Strouhal number in 0.295-0.305 (the zero-crossing one printed beside
   it), the Cl amplitude within 5% of 1.09; the FEM Ghia
   gate, ``cavity_fem(n=32, Re=100, dt=0.1)`` after 100 steps, RMS < 0.01
   on both centre lines; the implicit adjoint's gradient on the card
   against the CPU's (the Poiseuille loss of tests/test_fem.py:280, within
   1e-3 of its max); no kernel launched. The bench cells' marginal steps/s
   come in phase 13 (``bench --all``)
5n. gradients (``phase_gradients``): d mean(u²)/d u0 through 8
   steps of ``lid_cavity(n=24, Re=100, jacobi 8)`` on the chunk's loop route,
   held to 1e-4 of max|g| against the CPU's; the graph route refusing a
   state that requires grad before it captures anything; the fused 1024²
   cavity's kernel wrapper refusing a field that requires grad (the kernels
   have no backward); the adjoint example
   (``cfdsim_tpu_torch/examples/adjoint_forcing.py``) at its default size (n =
   48, 200 steps checkpointed per step) for 30 of its 60 Adam iterations: the
   largest coefficient error under 0.2, printed with the seconds; no kernel
   launched
5o. distributed (``phase_distributed``): a NCCL group of world size
   1 (the card's machine has one GPU; the exchanges between ranks are
   checked on gloo ranks on the CPU by tests/test_torch_*), then the
   explicit collocated cavity at 1024², Re = 1000, rbsor (the JAX
   package's PoissonConfig defaults), 10 steps against ``IncompressibleStep``
   (u, v rtol 1e-5 atol 1e-6; p rtol 1e-4 atol 1e-5), the explicit MAC
   cavity at 1024² with the pencil DCT against ``MACStep`` (u, v 2e-5; p
   2e-4), the explicit heated cavity at ``heated_cavity()``'s defaults, 20
   steps, against ``BoussinesqStep`` (u, v, θ 3e-5; Nu 1e-4) (the JAX
   tests' tolerances), each with its ms and device events per step beside
   the single-device step's (loop and captured); the sharded MAC gradient
   (16², rbsor 20, 4 steps) against the single-device one within 1e-5 of
   max|g|; no kernel launched
5p. the 2D staggered and 3D distributed steps (``phase_distributed_slices``)
   on the same group, at full width, each against its single-device step
   at the JAX tests' tolerances on the trimmed faces (θ too) and its
   metrics (p's largest |Δ| printed beside max|p|), profiled beside it:
   the 256³ ``cavity3d_mac`` (3 steps, u, v, w 2e-5), ``sphere()`` at
   192×96×96 (2e-5, fx 1e-4), the Re = 3900 stretched ghost sphere with
   dynamic LES of ``bench.sphere_paths`` on the central scheme and without
   its inlet perturbation (5e-5, fx 3e-4), ``heated_sphere_stretched`` (its
   defaults, central; 2e-5, Nu 2e-4), ``heated_cube()`` (10 steps, 5e-5, Nu
   1e-4 and 1e-3), ``cylinder_oscillating()`` 480×240 with the moving ghost
   (2e-5, forces 2e-4) and ``cylinder_stretched()`` 512×256 (2e-5, forces
   1e-4), 5 steps where not said; no kernel launched
5q. the pseudo-spectral and FEM distributed steps
   (``phase_distributed_tiers``) on the same group: the pencil-FFT step at
   1024² (``kolmogorov_ps`` with noise 0.1, 5 steps; real-space ω within
   2e-5 of max|ω|, energy, enstrophy and max speed 1e-5 relative) and the
   element-sharded monolithic and projection steps on ``bench.fem_paths``'
   cylinder (3 steps each; u within 5e-4 of max|u|, p and fx 5e-3), each
   step's wall ms beside the single-device step's and the Krylov counts
   beside the single-device ones; no kernel launched; the group destroyed
   at the end
5r. drivers (``phase_drivers``), as a user runs them:
   ``cylinder_reference_v5 --ref-parity --io native --max-steps 200`` (one
   200-step chunk at 600×180 through kernel A: healthy, snapshots at steps
   0 and 200 read back from the ``.csnap``, kernel-A launches = steps +
   warm-up), ``wedge_shock --t-final 0.5 --io native`` (its θ-β-M report
   finite) and ``sharded_mac_tiers --device cuda --ranks 1 --steps 20``
   (its own NCCL rank; each tier within 1e-5, 3D 2e-5, of its
   single-device step)
5s. the eight study drivers (``phase_study_drivers``), each through its
   ``main`` with ``--device cuda --io native`` at its published grid:
   ``sphere_wake --n 12`` (192×96×96, one 100-step chunk), ``tgv3d_les --n
   64`` (one 200-step chunk), ``sphere_les_re3900`` (320×160×160, two
   20-step chunks with ``--save``, then ``--resume`` for one more: the
   series file holds every step), ``kolmogorov_spectrum --n 256`` (the
   stable tier, 200 steps, and the pseudo-spectral one with friction, 200),
   ``cavity_rossiter`` (600×180, one 2000-step chunk), ``cavity_accuracy_1024``
   (1024², one 5000-step chunk to its npz, then a resume from it for one
   more), ``cylinder_fem 100`` (the case's mesh, one 10-step monolithic
   chunk: its line counts the accepted steps, none there as in the JAX
   driver, and says the flow did not advance; then the coarse h 0.3 → 1.5
   mesh, one 4-step chunk, every step accepted and the drag changing) and
   ``schafer_turek_2d2`` (10,752 triangles, projection, one
   50-step chunk): each report finite, its ``.csnap`` (or npz) read back at
   its last step, no kernel launched; wall and steps/s printed
6. main path: the 1024² Re=1000 cavity (the bench's ``dct_variant="auto"``,
   resolved when the step is built) through runner.Simulation, 600
   steps in captured chunks of 100, health check on; finite, max |u| ≤
   1.5, kernel launches = steps + the warm-up's (every kernel counts its
   own launches in device memory, so the graph's replays are counted where
   they run; the capture's eager warm-up is ``steps_per_graph`` steps, and
   its launches are launches); then one more chunk after a CFL back-off to 0.25 (the chunk's
   cfl buffer changes, dt follows, the graph is not captured again); then
   5 fused vs 5 unfused steps (atol 1e-5)
7. cylinder path: the reference-parity cylinder at its published 600×180,
   Re=600, SUPG, masked pressure solve through kernel A (1500 sweeps,
   ω=1.7, early exit at 1e-8 checked every 50 sweeps), 200 steps through
   runner.Simulation, health check on; finite, max |u| ≤ 5, fx finite,
   kernel-A launches = steps + warm-up (the whole early-exit solve is one
   cluster launch) and chunks run = steps × 30 (all run, counted on the
   device; the warm-up's are put back with the step's buffers);
   then 5 steps against the streaming rbsor solve from the same state (u,
   v atol 1e-5; p less its mean within 1e-3 of its max)
8. multigrid path: the 1024² Re=1000 cavity with ``poisson="mg:2"``, 200
   steps through runner.Simulation; finite, max |u| ≤ 1.5, kernel-B
   launches = (steps + warm-up) × 4 (fine level, pre and post smoothing, 2
   V-cycles) and kernel-A launches = (steps + warm-up) × 32 (8 coarser
   levels × 2 calls × 2 V-cycles: the 512² level's 4 on the cooperative
   route, the 28 below on a cluster); then 5 steps against plain smoothing from the same state,
   at the cylinder's bands
9. implicit cavity: ``lid_cavity(n=1024, Re=1000, diffusion="implicit",
   cfl=0.6)`` with the DCT projection, 200 steps through runner.Simulation
   in captured chunks (the step reads nothing on the host: dt·ν stays a
   device scalar through the DST Helmholtz solve); dt = 0.5·h, the case's
   dt_max, where the explicit path's viscous bound held 1.911e-4; no
   kernel launched; then ``solve_helmholtz_dirichlet`` on the final u at
   the step's coeff: max |(I − c∇²)u − b| on the interior ≤ 1e-4 · max |b|
   (checked in float64). The same case with ``poisson="mg:2"``, 50 steps:
   kernels A and B launched as in phase 8
10. Ghia gate: the 128² Re=100 implicit cavity (cfl 0.6) to t = 30 through
   runner.Simulation; ``validation.ghia_error`` < 0.006 on both centerline
   profiles (the row and tolerance of tests/test_ghia_slow.py:25-27)
11. the reference's flagship: ``cylinder(ref_parity=True, scheme="supg",
   use_les=True)`` at 600×180, Re=600, through kernel A as in phase 7, 200
   steps: healthy, kernel-A launches = steps + warm-up, chunks run = steps
   × 30, max ν_t > 0; then 50 steps of ``cylinder(scheme="tvd")`` with its
   default DCT solve (no kernel launched)
12. transport, snapshots and resume, through the command line's own
   ``run``: ``transport --n 1024 --Re 1000 --Pe 1000 --fused-predictor
   true --snapshot-interval 100 --chunk-steps 50``, 200 steps, then
   ``--resume`` for 200 more, against one run of 400: every field of the
   final snapshot bit-equal, and the states restored from both files
   ``torch.equal`` on every leaf; 0 ≤ θ ≤ hot_lid; the file holds steps 0,
   100, …, 400; the predictor launched once per step. Snapshots go through
   the writer named by ``SNAPSHOT_IO``; then seconds per snapshot at 1024²
13. timings, each beside the card's name and power limit: marginal
   cells/s of the main path fused and unfused (eager, host dispatch
   included) and the device time of one step; the predictor kernel vs
   plain torch at 1024²; (every DCT variant per shape: phase 5a); kernel
   A per 50-sweep call on each route (the masked 180×600 chunk on a
   cluster of 16, 32×48 on 1, 128×256 on 8, the masked 360×1200 on the
   cooperative kernel), the multigrid's 512² 2-sweep call on the
   cooperative route its plan takes and on a cluster of 16, and the
   cluster route's synchronisation per half-sweep at minimal work on
   clusters of 1, 8 and 16; kernel B per 1-, 2-, 4- and 8-sweep call at
   1024² (TMA) and per 2-sweep call at 1000×1030 (cp.async), each
   against its plain version; ``bench --all`` (marginal rbsor sweeps/s, MG
   V-cycles/s, DCT solves/s at 1024², ms per Helmholtz solve beside the
   DCT solve's, MAC-1024² and stretched-512² cells/s, and ms per step,
   chunk and eager, of the implicit cavity, the LES cylinder, the
   transport cavity, the heated and 3D cavities, the 3D bodies and the
   compressible and spectral cells (marginal between chunks of 5 and 15
   steps, 2 and 6 in 3D), and the sphere's cells/s), ``bench
   --roofline`` (the card's peaks, and flops,
   bytes per cell and bound of the collocated, MAC, stretched and sphere
   tiers), the profile of every path, staggered, 3D, compressible and
   spectral ones included (chunks of 3 steps, 2 in 3D), and
   ``bench --cylinder`` (steps/s through kernel A, captured and eager, and
   through streaming rbsor)
   (``cfdsim_tpu_torch/bench.py``).
   "Device" times replay the calls from a CUDA graph, so they exclude the
   host's dispatch; "eager" times include it. The predictor's, the DCT
   solve's and kernel B's inputs rotate through buffers twice the card's
   L2, so those calls stream from device memory as in a step; kernel A's
   problem is read once per call and then stays on chip, as it does in the
   cylinder's solve

Each phase's seconds are printed after it (``phase_seconds``) and all of them
on the ``smoke_seconds`` line. Before the last line it prints the card and a
``{"kernels": [...]}`` line:
per kernel its launches on the paths above (as the kernels counted them on
the device, warm-up included), the worst kernel-vs-plain
|Δ|, its device ms and its plain version's, and its bound: the larger of
the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the H100 SXM
data sheet); per route, the time of the route's call (``paths_ms``), and
for kernel A the measured µs of its cluster route's synchronisation per
half-sweep.

It imports nothing of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cfdsim_tpu_torch.bench import (
    CYLINDER_KERNEL_POISSON,
    EMPTY_SOURCE,
    POISSON,
    boussinesq_paths,
    cells_per_sec,
    compressible_paths,
    dct_solve_ms,
    fem_paths,
    mac_paths,
    new_paths,
    predictor_ms,
    profile_chunk,
    rbsor_blocked_ms,
    rbsor_ms,
    rbsor_sync_us,
    run_all,
    run_bench,
    run_cylinder,
    run_roofline,
    sphere_paths,
    spectral_paths,
    step_device_ms,
    threed_paths,
)
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build, heated_cavity, lid_cavity, lid_cavity_mac
from cfdsim_tpu_torch.examples import adjoint_forcing
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import cylinder_masks
from cfdsim_tpu_torch.io_ import restore
from cfdsim_tpu_torch.fem.sample import point_sampler, sample_fields
from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter, csnap_steps
from cfdsim_tpu_torch.models import compressible as comp
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.models import mac_stretched
from cfdsim_tpu_torch.models import spectral_ps as ps
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.monitor import check_compressible
from cfdsim_tpu_torch.ops.kernels import cuda_build
from cfdsim_tpu_torch.ops.kernels import poisson_rb as rb
from cfdsim_tpu_torch.ops.kernels import predictor as pred
from cfdsim_tpu_torch.ops.les import smagorinsky_viscosity
from cfdsim_tpu_torch.ops.les_dynamic import dynamic_cs2_3d
from cfdsim_tpu_torch.ops.stencil import laplacian
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
from cfdsim_tpu_torch.solvers import autotune, fdm
from cfdsim_tpu_torch.solvers.helmholtz import solve_helmholtz_dirichlet
from cfdsim_tpu_torch.solvers.poisson import (
    NeumannDCT,
    PoissonConfig,
    PoissonSolver,
    poisson_residual,
)
from cfdsim_tpu_torch.solvers.riemann import cons_to_prim
from cfdsim_tpu_torch.utils.profiling import card_name_and_power_limit
from cfdsim_tpu_torch.utils.tree import leaves, named_leaves
from cfdsim_tpu_torch.validation import (
    GHIA_U,
    GHIA_V,
    GHIA_X,
    GHIA_Y,
    botella_peyret_errors,
    ghia_error,
    sphere_drag_schiller_naumann,
)

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
KERNEL_ATOL = 1e-6  # tests/test_pallas.py:127-128; see csrc/predictor.cu on FMA
STEP_ATOL = 1e-5  # tests/test_pallas.py:144-145
GOLDEN_RTOL = 2e-5  # tests/test_goldens.py:28
# (shape, floats the fields start past a 16-byte boundary): every vector
# width of plan_predictor, the edge grids, and a base pointer that is only
# 4-byte aligned
PREDICTOR_CASES = [((48, 64), 0), ((1024, 1024), 0), ((1000, 1030), 0), ((37, 129), 0),
                   ((4096, 4096), 0), ((3, 3), 0), ((4, 5), 0), ((4, 8), 0), ((48, 64), 1)]
RBSOR_A_ATOL = 1e-6  # tests/test_pallas.py:28
RBSOR_B_ATOL = 5e-6  # tests/test_pallas.py:69-70
# kernel A's grids, one route or more each on the H100 (max cluster 16):
# (32, 48) the problem of tests/test_pallas.py:12-28, a cluster of 1;
# (37, 129) 2; (128, 256) 8; the cylinder's (180, 600) and, at 40 sweeps,
# (512, 512) 16;
# the cylinder at twice its resolution (360, 1200) and (768, 768) above the
# cluster's capacity: the cooperative route
KERNEL_A_SHAPES = [(32, 48), (37, 129), (128, 256), (180, 600), (512, 512), (360, 1200),
                   (768, 768)]
# 30 sweeps as in tests/test_pallas.py; 512², the largest band (8 rows per
# thread), takes the cluster at rb.CLUSTER_MIN_SWEEPS sweeps or more
KERNEL_A_SWEEPS = {(512, 512): 40}
CYLINDER_SHAPES = {(180, 600), (360, 1200)}  # these take the cylinder's solid mask
# (ny, nx, tile rows or None for the default, K, sweeps): tests/test_pallas.py:61,
# then the multigrid fine level's size with a tail pass, and ragged grids;
# the row pitch picks the load route: TMA (a multiple of 16 bytes: 48, 32,
# 1024), cp.async (1030, 33)
BLOCKED_CASES = [(64, 48, 16, 3, 10), (72, 32, 32, 8, 9), (1024, 1024, None, 8, 20),
                 (1000, 1030, None, 8, 19), (65, 33, None, 2, 5)]
# kernel A vs the streaming solve, 5 cylinder steps from the same state,
# and multigrid with kernel vs plain smoothing, 5 cavity steps: the same
# sweeps with each neighbour set summed in another order, from solves that
# are not converged. u, v are held to the cavity's step band (STEP_ATOL);
# p, less its mean (see _steps_apart), to 1e-3 of its max
CYL_UV_ATOL = MG_UV_ATOL = STEP_ATOL
CYL_P_RTOL = MG_P_RTOL = 1e-3
HELMHOLTZ_RTOL = 1e-4  # max interior residual of the DST solve over max |b|, at 1024²
GHIA_TOL = 0.006  # tests/test_ghia_slow.py:25: 128², Re=100, t=30, measured + 20%
DCT_VARIANT_RTOL = 1e-5  # every DCT variant against rfft, of max|φ| (tests/test_torch_dct_variants.py)
DCT_TIMING_SIZES = (256, 512, 1024, 2048, 4096)
FDM_RESIDUAL_RTOL = 1e-4  # ‖Lφ − rhs‖ / ‖rhs‖ of the stretched 512² solve under "high"
# the exact projection leaves div u at float32 roundoff: held to 1e-5 of
# max|u|/h, max|u| over the run (tests/test_torch_mac.py observed ≤ 4e-6 at
# 32², below 1e-5·32)
MAC_DIV_POST_RTOL = 1e-5
# the stretched tier's projection is four float32 matmuls (FDM), whose
# rounding leaves a residual some 300 ulp wide (phase 5b: 3.8e-5 of ‖rhs‖):
# its div u is held to 1e-4 of max|u|/h
FDM_DIV_POST_RTOL = 1e-4
# the goldens of the MAC tier (tests/test_goldens.py); the two keys of
# cylinder_mac_forces below float32 reproducibility take the bands of
# tests/test_torch_mac_cylinder.py: fy 2e-5 of the larger of |fx|, |fy|,
# max_p 1e-4 relative
MAC_GOLDENS = {"cavity_mac_48_re1000": (("cavity_mac", dict(n=48, Re=1000.0)), 300),
               "cylinder_mac_forces": (("cylinder_mac", dict(nx=96, ny=48, Re=100.0,
                                                              ibm_profile="sharp")), 200)}
GOLDEN_P_RTOL = 1e-4
BP_TOL = 0.009  # tests/test_mac_accuracy_slow.py:25: 128², Re=1000, t=200
# The snapshot writer of the resume phase. A machine that runs this script
# needs only torch, numpy, nvcc and g++ with zlib: the native writer
# (native/csnap.cc, compiled at first use) runs there, while the HDF5 writer
# needs h5py, which the card's machine was found not to have. ``restore``
# reads the .csnap container directly.
SNAPSHOT_IO = "native"
# the 3D bodies: the goldens of tests/test_goldens.py:42-54 (RTOL 2e-5 and
# its noise floor); the Re = 100 ghost-sphere drag within 2% of
# Schiller–Naumann's 1.092, run to t = 40 (examples/sphere_wake.py's run
# length: a steady wake), its lateral forces under 2% of the drag; the
# heated cube's hot-wall Nu at 48³, t = 0.4, within 1% of Tric et al.'s
# 2.054, the wall and mid-plane Nu within 0.5% of each other
# (tests/test_boussinesq.py:144-156), θ within the wall temperatures ± 1e-3
BODY_GOLDENS = {
    "sphere_ghost_ibm": (("sphere_stretched", dict(
        nx=36, ny=20, nz=20, Re=100.0, domain=(8.0, 4.0, 4.0), center=(2.0, 2.0, 2.0),
        refine_strength=2.0, refine_width=1.0, ibm_scheme="ghost", ibm_ramp_steps=4)), 60),
    "heated_sphere_nu": (("heated_sphere", dict(
        nx=32, ny=16, nz=16, Re=100.0, domain=(8.0, 4.0, 4.0), center=(2.0, 2.0, 2.0),
        ibm_ramp_steps=4)), 60),
}
DRAG_RTOL, DRAG_T_FINAL, LATERAL_RTOL = 0.02, 40.0, 0.02
CUBE_NU, CUBE_NU_RTOL, CUBE_BALANCE_RTOL, CUBE_T_FINAL = 2.054, 0.01, 5e-3, 0.4
# the full-width 3D body cells: steps through runner.Simulation (the
# dynamic-LES sphere's run is longer, so its coefficient has settled) and
# the largest |u| a healthy run has
BODY_PATH_STEPS, DYNAMIC_LES_STEPS = 50, 100
BODY_PATH_MAX_U = 3.0
# the compressible tier: the goldens of tests/test_goldens.py:38, :57-61; the
# Sod star states at t = 0.2 within 3% (tests/test_compressible.py:62-89,
# nx = 400, 50-step chunks); the θ-β-M gate of :232-263 at the reference's
# 400×200 (wedge-aligned frame, HLLC + MUSCL, t = 2.5): β within 0.5° of
# 39.31°, ρ₂ and p₂ within 1% of 1.458 and 1.707, |v| < 0.01; the blast's
# gates at 64³ (mass and energy to 1e-4, the three axis profiles within
# 0.02, tests/test_compressible3d.py:119-148, its 40 steps at 32³ doubled);
# the reference cavity's target speed (BASELINE.md:13)
COMPRESSIBLE_GOLDENS = {
    "wedge_shock": (("wedge", dict(nx=120, ny=60)), 150),
    "cavity_supersonic_pin": (("cavity_supersonic", dict(nx=150, ny=45)), 150),
    "cavity_supersonic_real": (("cavity_supersonic", dict(nx=150, ny=45,
                                                          real_geometry=True)), 150),
}
SOD_STAR = {"rho_left": 0.42632, "rho_right": 0.26557, "p": 0.30313, "u": 0.92745}
SOD_RTOL = 0.03
BETA_DEG, BETA_TOL_DEG, RHO2, P2, JUMP_RTOL, V_MAX = 39.31, 0.5, 1.458, 1.707, 0.01, 0.01
BLAST_GATE_N, BLAST_GATE_STEPS, BLAST_RTOL, BLAST_AXIS_TOL = 64, 80, 1e-4, 0.02
CAVITY_TARGET_STEPS_PER_S = 100.0
COMPRESSIBLE_PATH_STEPS = 300
# the spectral tier: the reference's Kolmogorov run (BASELINE.md:20: 640×360,
# dt = 0.01, 750 steps); the pseudo-spectral gates of
# tests/test_spectral_ps.py:51-82: the inviscid Taylor–Green energy at 96²
# over 500 steps to 1e-4, the forced laminar profile at 64² (t = 16) within
# 5e-3 of fs/(νk²+α) with |v| under 1e-4 of it
KOLMOGOROV_STEPS = 750
TG_N, TG_STEPS, TG_RTOL = 96, 500, 1e-4
FIXED_N, FIXED_STEPS, FIXED_RTOL, FIXED_V = 64, 8000, 5e-3, 1e-4
# the FEM tier: the Schäfer–Turek 2D-2 gate at examples/schafer_turek_2d2.py:37-46
# (projection, P1-P1, h 0.0035 → 0.015 with the wake band, ~10.7k triangles,
# θ = ½, dt = 0.002) to t = 12 with the tail from t = 6: the published bands
# on the tail's largest Cd (the benchmark's c_D,max, 3.22-3.24; the JAX
# package's saturated 3.228) and on the St of the lift's FFT (0.295-0.305),
# the Cl amplitude within 5% of the JAX package's 1.09, and the tail's mean
# Cd within 1% of the JAX package's 3.19 for the same window (its run of
# this configuration, BENCHNOTES.md:614: the drag still rises through
# t = 6-12);
# where the first 250 steps say the run would take over ST_BUDGET_S, it
# stops at t = 8 with the tail from t = 4. The FEM Ghia gate: cavity_fem(n=32, Re=100,
# dt=0.1), 100 steps, RMS < 0.01 on both centre lines
# (tests/test_fem.py:348-373). Twenty projection steps twice: the same bits.
ST_CONFIG = dict(re=100.0, scheme="projection", h_near=0.0035, h_far=0.015, wake_refine=True,
                 dt=0.002, theta=0.5)
ST_RUNS = ((12.0, 6.0), (8.0, 4.0))  # (t_final, tail from), the second when over budget
ST_BUDGET_S = 300.0
ST_CD_MAX, ST_ST, ST_CL_AMP, ST_CL_RTOL = (3.22, 3.24), (0.295, 0.305), 1.09, 0.05
ST_CD_MEAN, ST_CD_MEAN_RTOL = 3.19, 0.01
ST_CHUNK = 50
FEM_GHIA_TOL, FEM_GHIA_STEPS, FEM_REPRO_STEPS, FEM_PROFILE_STEPS = 0.01, 100, 20, 3
FEM_GRAD_RTOL = 1e-3  # the card's gradient against the CPU's (float32 sums in other orders)
# gradients: the 8-step cavity's gradient on the card against the
# CPU's, 1e-4 of max|g| (the FEM adjoint's check held 1.4e-5 on the same
# pattern); the adjoint example's recovered coefficients within 0.2
# (tests/test_differentiability.py:109)
GRAD_STEPS, GRAD_CARD_RTOL, ADJOINT_ERR = 8, 1e-4, 0.2
# the adjoint example's Adam iterations (its default 60 ends 0.029 from the
# coefficients on the card; 40 end 0.091 and 30 end 0.018 on the CPU)
ADJOINT_ITERS = 30
# the distributed steps at world size 1: steps held against the single-device
# step (the JAX tests' tolerances: tests/test_explicit_step.py:37-42,
# tests/test_mac_explicit.py:74, tests/test_boussinesq.py:80-86)
DIST_STEPS, BQ_DIST_STEPS = 10, 20
# to make room for the gradient and distributed phases, steps were
# cut, never grids: the profiled chunks of phase 13 (2D, 3D; were 10 and
# 5), `bench --all`'s marginal chunks (2D, 3D; were 10-30 and 3-9) and the
# FEM cells' profiled steps (5 before); then, for phases 5q and 5r, phase
# 4's steps (20 before), the adjoint example's iterations (60) and phase
# 5o's steps (20 and 40); for phase 5s the adjoint example's iterations
# again (40)
CHUNK_ROUTE_STEPS = 10
PROFILE_STEPS, PROFILE_STEPS_3D = 3, 2
# the 2D staggered and 3D distributed steps at world size 1 (phase 5p):
# steps held against the single-device step, and the profiled steps
DIST_SLICE_STEPS, DIST_SLICE_STEPS_CUBE, DIST_SLICE_PROFILE = 5, 10, 2
# the pseudo-spectral and FEM distributed steps at world size 1 (phase 5q):
# steps, and the tolerances of tests/test_spectral_ps.py:136-140 (ω of
# max|ω|, the metrics relative) and tests/test_fem_explicit.py:72-75 (u of
# max|u|, p and fx absolute)
DIST_TIER_PS_STEPS, DIST_TIER_FEM_STEPS = 5, 3
PS_DIST_W_RTOL, PS_DIST_METRIC_RTOL = 2e-5, 1e-5
FEM_DIST_U_RTOL, FEM_DIST_P_ATOL, FEM_DIST_FX_ATOL = 5e-4, 5e-3, 5e-3
# the example drivers (phase 5r): one 200-step chunk of the reference-parity
# cylinder, the wedge to t = 0.5, 20 steps of the staggered tiers; each
# tier within the dry run's bounds of its single-device step
DRIVER_V5_STEPS, DRIVER_WEDGE_T, DRIVER_MAC_TIER_STEPS = 200, 0.5, 20
DRIVER_MAC_TIER_ATOL = {"2D MAC (DCT)": 1e-5, "2D stretched (FDM)": 1e-5,
                        "3D MAC (3D DCT)": 2e-5}
# the study drivers at their published grids: one chunk each (two and a
# resume for the Re = 3900 sphere and the 1024² accuracy run)
STUDY_SPHERE_STEPS, STUDY_TGV_STEPS, STUDY_RE3900_CHUNK = 100, 200, 20
STUDY_KOLMOGOROV = {"stable": ["--t", "2", "--chunk", "200"],
                    "ps": ["--dt", "0.002", "--t", "0.4", "--chunk", "200", "--alpha", "0.1",
                           "--noise", "0.05"]}
STUDY_ROSSITER_STEPS, STUDY_ACCURACY_N, STUDY_ACCURACY_CHUNK = 2000, 1024, 5000
STUDY_FEM_CYLINDER_STEPS, STUDY_FEM_COARSE_STEPS, STUDY_SCHAFER_TUREK_STEPS = 10, 4, 50
SECONDARY_STEPS, SECONDARY_STEPS_3D = (5, 15), (2, 6)
SMOKE_OUT = ROOT / "out" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12
PREDICTOR_FLOPS_PER_CELL = pred.FLOPS_PER_CELL
RBSOR_FLOPS_PER_UPDATE = rb.FLOPS_PER_UPDATE


def say(phase: str, **fields):
    """One JSON line: the phase, its fields, and the seconds since the
    smoke started (``at_s``)."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T_START}),
          flush=True)


def machine_has() -> dict:
    """Which optional packages and tools this machine has: what the
    snapshot writers (h5py; g++ and zlib for the native one), the runner's
    progress bar and memory line, and the render pipeline need."""
    has = {name: importlib.util.find_spec(name) is not None
           for name in ("h5py", "matplotlib", "tqdm", "psutil", "PIL")}
    has.update({tool: shutil.which(tool) is not None for tool in ("g++", "ffmpeg")})
    has["zlib.h"] = any(Path(d, "zlib.h").is_file()
                        for d in ("/usr/include", "/usr/local/include"))
    return has


def phase_kernel_vs_plain():
    worst = 0.0
    widths = set()
    for (ny, nx), offset in PREDICTOR_CASES:
        rng = np.random.default_rng(ny * 10007 + nx)
        # contiguous fields that start `offset` floats into a longer buffer
        u, v = (torch.tensor(rng.standard_normal(ny * nx + offset), dtype=torch.float32,
                             device="cuda")[offset:].view(ny, nx) for _ in range(2))
        dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
        nu, dx, dy = 0.01, 0.02, 0.03
        plan = pred.plan_predictor((ny, nx), pred.pointer_alignment(u, v))
        widths.add(plan.vec)
        us, vs = pred.fused_predictor_central(u, v, dt, nu, dx, dy)
        ur, vr = pred.fused_predictor_central_ref(u, v, dt, nu, dx, dy)
        torch.cuda.synchronize()
        err = max(float((us - ur).abs().max()), float((vs - vr).abs().max()))
        frame = torch.ones_like(u, dtype=torch.bool)
        frame[1:-1, 1:-1] = False
        frame_equal = bool(torch.equal(us[frame], u[frame]) and torch.equal(vs[frame], v[frame]))
        say("kernel_vs_plain", shape=[ny, nx], pointer_alignment=pred.pointer_alignment(u, v),
            route=plan.route, max_abs_err=err, atol=KERNEL_ATOL, frame_bit_equal=frame_equal)
        if not (err <= KERNEL_ATOL and frame_equal):
            raise AssertionError(f"fused predictor disagrees at {(ny, nx)}: {err}, frame {frame_equal}")
        worst = max(worst, err)
    if widths != {1, 2, 4}:
        raise AssertionError(f"the predictor ran vector widths {sorted(widths)}, not 1, 2 and 4")
    return worst


def _bound_ms(bytes_moved: float, flops: float):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the float32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _cuda(a):
    return torch.tensor(np.asarray(a), device="cuda")


def _rbsor_problem(shape, seed=0):
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(shape).astype(np.float32)
    rhs -= rhs.mean()
    solid = np.zeros(shape, dtype=bool)
    ny, nx = shape
    solid[ny * 10 // 32:ny * 14 // 32, nx * 20 // 48:nx * 24 // 48] = True
    return np.zeros_like(rhs), rhs, solid


def _check(label, got, want, atol, **fields):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bit_equal = bool(torch.equal(got, want))
    say(label, max_abs_err=err, atol=atol, bit_equal=bit_equal, **fields)
    if not err <= atol:
        raise AssertionError(f"{label} {fields}: max |Δ| {err} > {atol}")
    return err


def _cylinder_solid(shape):
    """The cylinder case's solid mask on its domain at this resolution."""
    ny, nx = shape
    solid, _ = cylinder_masks(Grid(nx=nx, ny=ny, x_max=20.0, y_max=4.0), (4.0, 2.0), 0.5)
    return solid


def phase_rbsor_vs_plain():
    worst_a = worst_b = 0.0
    max_cluster = rb.max_cluster("cuda")
    routes_a, routes_b = set(), set()
    # kernel A: the test_pallas problem (h = 1/32), then larger grids; the
    # cylinder's grids use its own solid mask
    for shape in KERNEL_A_SHAPES:
        phi0, rhs, solid = _rbsor_problem(shape)
        if shape in CYLINDER_SHAPES:
            solid = _cylinder_solid(shape)
        sweeps = KERNEL_A_SWEEPS.get(shape, 30)
        plan = rb.plan_rbsor(shape, max_cluster, sweeps=sweeps)
        routes_a.add((plan.route, plan.cluster))
        for bc, mask in [("neumann", None), ("dirichlet", None), ("neumann", solid)]:
            m = None if mask is None else _cuda(mask)
            args = (_cuda(phi0), _cuda(rhs), 1.0 / 32, 1.0 / 32, sweeps, 1.7, bc, m)
            worst_a = max(worst_a, _check("rbsor_a_vs_plain", rb.rbsor(*args), rb.rbsor_ref(*args),
                                          RBSOR_A_ATOL, shape=list(shape), bc=bc,
                                          masked=mask is not None, sweeps=sweeps, route=plan.route,
                                          cluster=plan.cluster))
    want = {("cluster", 1), ("cluster", 8), ("cluster", 16), ("cooperative", 0)}
    if not want <= routes_a:
        raise AssertionError(f"kernel A took the routes {sorted(routes_a)}, not all of {want}")
    # kernel B against A and against its plain version
    rs = np.random.RandomState(7)
    for ny, nx, tile, k, iters in BLOCKED_CASES:
        rhs = _cuda(rs.randn(ny, nx).astype(np.float32))
        phi0 = _cuda(rs.randn(ny, nx).astype(np.float32))
        plan = rb.plan_blocked((ny, nx), min(k, iters), tile)
        routes_b.add(plan.route)
        got = rb.rbsor_blocked(phi0, rhs, 0.02, 0.03, iters, 1.7, tile, k)
        fields = dict(shape=[ny, nx], tile=[plan.tile_rows, plan.tile_cols], sweeps_per_pass=k,
                      sweeps=iters, route=plan.route)
        worst_b = max(worst_b,
                      _check("rbsor_b_vs_a", got, rb.rbsor(phi0, rhs, 0.02, 0.03, iters, 1.7),
                             RBSOR_B_ATOL, **fields),
                      _check("rbsor_b_vs_plain", got,
                             rb.rbsor_blocked_ref(phi0, rhs, 0.02, 0.03, iters, 1.7, tile, k),
                             RBSOR_B_ATOL, **fields))
    if routes_b != set(rb.B_ROUTES):
        raise AssertionError(f"kernel B took the routes {sorted(routes_b)}, not all of "
                             f"{sorted(rb.B_ROUTES)}")
    # the early exit, one solve per route: a tol the 48² problem reaches,
    # then on the cylinder's grid (a cluster of 16) and at twice its
    # resolution (cooperative) the residual the plain version has after 3
    # chunks; the kernel runs the same chunks as the plain version. On the
    # cluster of 16 also with a check after every sweep, where a CTA may
    # reach the next chunk's residual before a distant one has read this one's
    for shape, tol, check in [((48, 48), 1e-3, 50), ((180, 600), None, 50),
                              ((360, 1200), None, 50), ((180, 600), None, 1)]:
        rhs = np.random.RandomState(1).randn(*shape).astype(np.float32)
        rhs -= rhs.mean()
        h = 1.0 / shape[0]
        mask = None if shape == (48, 48) else _cuda(_cylinder_solid(shape))
        if tol is None:
            three = rb.rbsor_ref(torch.zeros(shape, device="cuda"), _cuda(rhs), h, h, 3 * check,
                                 1.7, "neumann", mask)
            tol = float(poisson_residual(three, _cuda(rhs), h, h, mask, "neumann"))
        counts = [torch.zeros((), dtype=torch.int32, device="cuda") for _ in range(2)]
        outs = [fn(torch.zeros(shape, device="cuda"), _cuda(rhs), h, h, 4000, 1.7, "neumann",
                   mask, tol=tol, check_every=check, chunks_run=c)
                for fn, c in zip((rb.rbsor, rb.rbsor_ref), counts)]
        chunks = [int(c) for c in counts]
        plan = rb.plan_rbsor(shape, max_cluster, sweeps=4000 // check * check)
        worst_a = max(worst_a, _check("rbsor_a_early_exit", outs[0], outs[1],
                                      RBSOR_A_ATOL * float(outs[1].abs().max()),
                                      shape=list(shape), tol=tol, check_every=check,
                                      chunks_kernel=chunks[0],
                                      chunks_plain=chunks[1], route=plan.route,
                                      cluster=plan.cluster))
        if chunks[0] != chunks[1] or not chunks[0] < 4000 // check:
            raise AssertionError(f"early exit at {shape} ran {chunks} chunks (kernel, plain)")
    return worst_a, worst_b


def _reset_counts():
    for k in (pred.KERNEL, *rb.KERNELS):
        k.reset_launches()


def _counts():
    """Each kernel's launches since :func:`_reset_counts`, read from the
    counts the kernels keep in device memory."""
    torch.cuda.synchronize()
    return {"predictor": pred.KERNEL.launches, "rbsor_a": rb.KERNEL_A.launches,
            "rbsor_a_cooperative": rb.KERNEL_A_COOP.launches, "rbsor_b": rb.KERNEL_B.launches}


def _run(case, steps, chunk, warmup_div_threshold=20.0):
    cfg = RunnerConfig(t_final=1e9, max_steps=steps, chunk_steps=chunk, health_check=True,
                       div_threshold=50.0, warmup_div_threshold=warmup_div_threshold,
                       max_velocity=getattr(case.cfg, "max_velocity", 1e3), log_every_chunks=0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    t0 = time.perf_counter()
    state, report = sim.run()
    torch.cuda.synchronize()
    if sim.chunk.mode != "graph":
        raise AssertionError(f"the runner took the {sim.chunk.mode} route: {sim.chunk.reason}")
    return sim, state, report, time.perf_counter() - t0


def _chunk_facts(sim):
    program = sim.chunk.program
    return dict(route=sim.chunk.mode, steps_per_graph=sim.chunk.steps_per_graph,
                warmup_steps=sim.chunk.steps_per_graph, capture_s=program.capture_seconds,
                replays=program.replays)


def _healthy(label, state, report, steps, max_u):
    finite = all(bool(torch.isfinite(x).all()) for x in leaves(state))
    got_u = float(getattr(state, "flow", state).u.abs().max())
    if report["stopped_reason"] or int(state.step) != steps:
        raise AssertionError(f"{label} stopped early: {report['stopped_reason']!r} at "
                             f"{int(state.step)}")
    if not finite or not got_u <= max_u:
        raise AssertionError(f"{label} unhealthy: finite={finite} max|u|={got_u}")
    return finite, got_u


def phase_cylinder():
    steps = 200
    case = build("cylinder", ref_parity=True, scheme="supg", poisson=CYLINDER_KERNEL_POISSON,
                 device="cuda")
    chunks_run = case.step.poisson.chunks_run
    _reset_counts()
    chunks_run.zero_()
    sim, state, report, wall = _run(case, steps, 50)
    launches = _counts()
    chunks = int(chunks_run)
    _, max_u = _healthy("cylinder", state, report, steps, case.cfg.max_velocity)
    n_chunks = CYLINDER_KERNEL_POISSON.iters // CYLINDER_KERNEL_POISSON.check_every
    cfl = torch.ones((), dtype=torch.float32, device="cuda")
    _, m = case.step(state, cfl)  # one more step for the body force (not counted)
    fx, fy = float(m.fx), float(m.fy)
    say("cylinder_path", nx=600, ny=180, Re=600.0, steps=int(state.step), launches=launches,
        kernel_chunks_run=chunks, kernel_chunks_per_step=chunks / steps, max_abs_u=max_u,
        fx=fx, fy=fy, t=report["final_time"], last_chunk=sim.metrics_history[-1],
        wall_s=wall, **_chunk_facts(sim), device_peak_bytes=report.get("device_peak_bytes"))
    if not (math.isfinite(fx) and math.isfinite(fy)):
        raise AssertionError(f"cylinder force not finite: {fx}, {fy}")
    # the whole early-exit solve is one cluster launch per step, the
    # capture's eager warm-up steps included; all 30 chunks run (tol 1e-8 is
    # below float32's reach; the warm-up's are put back with the step's buffers)
    ran = steps + sim.chunk.steps_per_graph
    want = {"predictor": 0, "rbsor_a": ran, "rbsor_a_cooperative": 0, "rbsor_b": 0}
    if launches != want or chunks != steps * n_chunks:
        raise AssertionError(f"cylinder path launches {launches} and {chunks} chunks, expected "
                             f"{want} and {steps * n_chunks}")

    # kernel A vs the streaming solve from the same state (not counted)
    other = build("cylinder", ref_parity=True, scheme="supg", device="cuda")
    diff = _steps_apart(case, other, state, 5)
    say("cylinder_kernel_vs_streaming", steps=5, **diff, uv_atol=CYL_UV_ATOL,
        p_rtol=CYL_P_RTOL)
    if not (diff["du"] <= CYL_UV_ATOL and diff["dv"] <= CYL_UV_ATOL
            and diff["dp"] <= CYL_P_RTOL * diff["p_max"]):
        raise AssertionError(f"cylinder kernel vs streaming: {diff}")
    return launches["rbsor_a"], chunks / steps


def _steps_apart(a, b, state, steps):
    cfl = torch.ones((), dtype=torch.float32, device="cuda")
    sa = sb = state
    for _ in range(steps):
        sa, _ = a.step(sa, cfl)
        sb, _ = b.step(sb, cfl)
    out = {f"d{k}": float((getattr(sa, k) - getattr(sb, k)).abs().max()) for k in ("u", "v")}
    # the Neumann problem fixes p up to a constant, which the velocity never
    # sees and which warm-started solves drift along by their rounding:
    # compare p less its mean
    pa, pb = sa.p - sa.p.mean(), sb.p - sb.p.mean()
    out["dp"] = float((pa - pb).abs().max())
    out["dp_with_mean"] = float((sa.p - sb.p).abs().max())
    out["p_max"] = float(pb.abs().max())
    return out


def phase_mg_cavity():
    steps = 200
    case = lid_cavity(n=1024, Re=1000.0, poisson="mg:2", device="cuda")
    _reset_counts()
    sim, state, report, wall = _run(case, steps, 50)
    launches = _counts()
    _, max_u = _healthy("mg_cavity", state, report, steps, 1.5)
    say("mg_path", n=1024, Re=1000.0, steps=int(state.step), launches=launches,
        max_abs_u=max_u, t=report["final_time"], last_chunk=sim.metrics_history[-1],
        wall_s=wall, **_chunk_facts(sim), device_peak_bytes=report.get("device_peak_bytes"))
    # per V-cycle: the 1024² level's pre and post smoothing through kernel B,
    # 2 calls on each of the 8 coarser levels through kernel A: 512² (2
    # sweeps on large bands) on the cooperative route, 256² … 4² on a
    # cluster; the capture's eager warm-up steps are steps too
    ran = steps + sim.chunk.steps_per_graph
    want = {"predictor": 0, "rbsor_a": ran * 2 * 14, "rbsor_a_cooperative": ran * 2 * 2,
            "rbsor_b": ran * 2 * 2}
    if launches != want:
        raise AssertionError(f"multigrid path launches {launches}, expected {want}")

    plain = lid_cavity(n=1024, Re=1000.0, device="cuda",
                       poisson=PoissonConfig(method="mg", iters=2, mg_pallas_smooth=False))
    diff = _steps_apart(case, plain, state, 5)
    say("mg_kernel_vs_plain_smoothing", steps=5, **diff, uv_atol=MG_UV_ATOL, p_rtol=MG_P_RTOL)
    if not (diff["du"] <= MG_UV_ATOL and diff["dv"] <= MG_UV_ATOL
            and diff["dp"] <= MG_P_RTOL * diff["p_max"]):
        raise AssertionError(f"multigrid kernel vs plain smoothing: {diff}")
    return launches


def _paths(compute_metrics=True):
    """The three paths' cases: the 1024² DCT cavity with the fused predictor,
    the 600×180 reference-parity cylinder through kernel A, the 1024²
    ``mg:2`` cavity."""
    return {
        "cavity1024_dct_fused": lid_cavity(
            n=1024, Re=1000.0, poisson=POISSON, compute_metrics=compute_metrics,
            fused_predictor=True, device="cuda"),
        "cylinder600x180_rbsor_pallas": build(
            "cylinder", ref_parity=True, scheme="supg", poisson=CYLINDER_KERNEL_POISSON,
            compute_metrics=compute_metrics, device="cuda"),
        "cavity1024_mg2": lid_cavity(n=1024, Re=1000.0, poisson="mg:2",
                                     compute_metrics=compute_metrics, device="cuda"),
    }


def phase_chunk_routes():
    """The captured chunk against the eager loop, ``CHUNK_ROUTE_STEPS`` steps
    from one state."""
    steps = CHUNK_ROUTE_STEPS
    macs = mac_paths(1024, compute_metrics=True, device="cuda")
    threed = threed_paths(256, compute_metrics=True, device="cuda")
    bodies = sphere_paths(compute_metrics=True, device="cuda")
    compressible = compressible_paths(compute_metrics=True, device="cuda")
    spectral = spectral_paths(compute_metrics=True, device="cuda")
    paths = {**_paths(), **new_paths(compute_metrics=True), **macs,
             **boussinesq_paths(1024, device="cuda"), **threed, **bodies, **compressible,
             **spectral}
    # plain torch, cuFFT and cuBLAS only
    no_kernel = {"cavity1024_implicit_dst", "cavity1024_les_implicit_jacobi",
                 "heated_cavity1024_dct", *threed, *bodies, *compressible, *spectral,
                 *(k for k in macs if not k.endswith("_mg2"))}
    for path, case in paths.items():
        graph = make_chunk(case.cfg, case.step, steps, keep_graph=True)
        loop = make_chunk(case.cfg, case.step, steps, route="loop")
        if (graph.mode, loop.mode) != ("graph", "loop"):
            raise AssertionError(f"{path}: routes {graph.mode}, {loop.mode}")
        # from a developed state: the same steps through the loop first
        state, _ = loop(case.state, 1.0)
        _reset_counts()
        sg, mg = graph(state, 1.0)  # the eager warm-up, the capture, then the replays
        by_graph = _counts()
        _reset_counts()
        sl, ml = loop(state, 1.0)
        by_loop = _counts()
        apart = [k for (k, a), b in zip(named_leaves(sg) + named_leaves(mg),
                                        leaves(sl) + leaves(ml)) if not torch.equal(a, b)]
        say("chunk_graph_vs_loop", path=path, steps=steps, bit_equal=not apart, differ=apart,
            steps_per_graph=graph.steps_per_graph, nodes=graph.program.nodes,
            capture_s=graph.program.capture_seconds,
            launches_graph=by_graph, launches_loop=by_loop, reason=graph.reason)
        # the kernels count their own launches on the device: the replays ran
        # what the loop ran, and the warm-up steps_per_graph steps more
        scale = (steps + graph.steps_per_graph) / steps
        if by_graph != {k: round(n * scale) for k, n in by_loop.items()} or any(
                by_loop.values()) == (path in no_kernel):
            raise AssertionError(f"{path}: the captured chunk launched {by_graph}, the loop "
                                 f"{by_loop}")
        if apart or int(sg.step) != 2 * steps or mg.dt.shape != (steps,):
            raise AssertionError(f"{path}: the captured chunk and the eager loop differ in {apart}")
        del graph, loop, sg, sl
        torch.cuda.empty_cache()
    # the host-reading streaming solve takes the loop, by the decision made before it runs
    streaming = build("cylinder", ref_parity=True, scheme="supg", device="cuda")
    chunk = make_chunk(streaming.cfg, streaming.step, 2)
    say("chunk_route", path="cylinder600x180_streaming_rbsor", route=chunk.mode,
        reason=chunk.reason)
    if chunk.mode != "loop":
        raise AssertionError("the streaming early exit reads the host: its chunk is the loop")


def phase_implicit_cavity():
    """The implicit (DST Helmholtz) cavity at 1024² with the DCT projection,
    then with ``mg:2``."""
    steps = 200
    case = lid_cavity(n=1024, Re=1000.0, diffusion="implicit", cfl=0.6, device="cuda")
    if case.step.reads_host or not case.step.use_dst:
        raise AssertionError("the implicit DST step must read nothing on the host")
    _reset_counts()
    # from rest at dt = 0.5·h the lid corners' divergence spike, which scales
    # with 1/h, stands at 20.7 at 1024² just inside the metric's 2-node frame
    # (20.0 is the runner's default bound for the first 1000 steps)
    sim, state, report, wall = _run(case, steps, 50, warmup_div_threshold=50.0)
    launches = _counts()
    _, max_u = _healthy("implicit_cavity", state, report, steps, 1.5)
    h = case.grid.dx
    dt = sim.metrics_history[-1]["dt"]
    # the Helmholtz solve alone, on the final u at the step's coeff, against
    # the operator applied in float64
    coeff = torch.tensor(dt * case.cfg.nu, dtype=torch.float32, device="cuda")
    b = state.u
    sol = solve_helmholtz_dirichlet(b, coeff, h, h).double()
    res = (sol - coeff.double() * laplacian(sol, h, h) - b.double())[1:-1, 1:-1].abs().max()
    rel = float(res) / float(b.abs().max())
    say("implicit_cavity_path", n=1024, Re=1000.0, steps=int(state.step), launches=launches,
        dt=dt, dt_expected=0.5 * h, max_abs_u=max_u, t=report["final_time"],
        helmholtz_rel_residual=rel, helmholtz_rtol=HELMHOLTZ_RTOL,
        last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim))
    if abs(dt - 0.5 * h) > 1e-6 * 0.5 * h:
        raise AssertionError(f"implicit dt {dt} is not the case's dt_max {0.5 * h}")
    if any(launches.values()):
        raise AssertionError(f"the implicit DCT cavity launched kernels: {launches}")
    if not rel <= HELMHOLTZ_RTOL:
        raise AssertionError(f"Helmholtz residual {rel} of max |b| at 1024²")

    steps = 50
    case = lid_cavity(n=1024, Re=1000.0, diffusion="implicit", cfl=0.6, poisson="mg:2",
                      device="cuda")
    _reset_counts()
    sim, state, report, wall = _run(case, steps, 50, warmup_div_threshold=50.0)
    launches = _counts()
    _, max_u = _healthy("implicit_mg_cavity", state, report, steps, 1.5)
    say("implicit_mg_path", n=1024, Re=1000.0, steps=int(state.step), launches=launches,
        max_abs_u=max_u, t=report["final_time"], last_chunk=sim.metrics_history[-1],
        wall_s=wall, **_chunk_facts(sim))
    ran = steps + sim.chunk.steps_per_graph  # as in phase_mg_cavity
    want = {"predictor": 0, "rbsor_a": ran * 2 * 14, "rbsor_a_cooperative": ran * 2 * 2,
            "rbsor_b": ran * 2 * 2}
    if launches != want:
        raise AssertionError(f"implicit multigrid path launches {launches}, expected {want}")
    return launches


def phase_ghia():
    """The physics gate of the implicit path: Ghia's Re=100 profiles at 128²."""
    case = lid_cavity(n=128, Re=100.0, diffusion="implicit", cfl=0.6, device="cuda")
    cfg = RunnerConfig(t_final=30.0, chunk_steps=500, health_check=True, div_threshold=50.0,
                       max_velocity=case.cfg.max_velocity, log_every_chunks=0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    t0 = time.perf_counter()
    state, report = sim.run()
    wall = time.perf_counter() - t0
    if report["stopped_reason"] or report["chunk_route"] != "graph":
        raise AssertionError(f"Ghia run: {report}")
    eu, ev = (float(e) for e in ghia_error(state.u.cpu().numpy(), state.v.cpu().numpy(), 100,
                                           case.grid.y_coords(), case.grid.x_coords()))
    say("ghia_gate", n=128, Re=100, t=report["final_time"], steps=report["final_step"],
        err_u=eu, err_v=ev, tol=GHIA_TOL, wall_s=wall)
    if not (eu < GHIA_TOL and ev < GHIA_TOL):
        raise AssertionError(f"Ghia Re=100 at 128²: RMS errors {eu}, {ev} (tol {GHIA_TOL})")


def phase_les_cylinder():
    """The LES + SUPG + IBM cylinder through kernel A; then the TVD cylinder."""
    steps = 200
    case = build("cylinder", ref_parity=True, scheme="supg", use_les=True,
                 poisson=CYLINDER_KERNEL_POISSON, device="cuda")
    chunks_run = case.step.poisson.chunks_run
    _reset_counts()
    chunks_run.zero_()
    sim, state, report, wall = _run(case, steps, 50)
    launches = _counts()
    chunks = int(chunks_run)
    _, max_u = _healthy("les_cylinder", state, report, steps, case.cfg.max_velocity)
    g = case.grid
    nu_t_max = float(smagorinsky_viscosity(state.u, state.v, g.dx, g.dy,
                                           case.cfg.smagorinsky_constant).max())
    say("les_cylinder_path", nx=600, ny=180, Re=600.0, steps=int(state.step),
        launches=launches, kernel_chunks_run=chunks, max_abs_u=max_u, nu_t_max=nu_t_max,
        nu=case.cfg.nu, t=report["final_time"], last_chunk=sim.metrics_history[-1],
        wall_s=wall, **_chunk_facts(sim))
    n_chunks = CYLINDER_KERNEL_POISSON.iters // CYLINDER_KERNEL_POISSON.check_every
    ran = steps + sim.chunk.steps_per_graph
    want = {"predictor": 0, "rbsor_a": ran, "rbsor_a_cooperative": 0, "rbsor_b": 0}
    if launches != want or chunks != steps * n_chunks:
        raise AssertionError(f"LES cylinder launches {launches} and {chunks} chunks, expected "
                             f"{want} and {steps * n_chunks}")
    if not nu_t_max > 0.0:
        raise AssertionError("the LES cylinder's eddy viscosity is zero everywhere")

    tvd = build("cylinder", scheme="tvd", device="cuda")
    _reset_counts()
    sim, state, report, wall = _run(tvd, 50, 50)
    tvd_launches = _counts()
    _, max_u = _healthy("tvd_cylinder", state, report, 50, tvd.cfg.max_velocity)
    say("tvd_cylinder_path", nx=600, ny=180, steps=int(state.step), launches=tvd_launches,
        max_abs_u=max_u, last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim))
    if any(tvd_launches.values()):
        raise AssertionError(f"the TVD cylinder (DCT solve) launched kernels: {tvd_launches}")
    return launches["rbsor_a"]


def phase_transport_resume():
    """Transport, snapshots and a bit-exact resume through the command line."""
    shutil.rmtree(SMOKE_OUT, ignore_errors=True)
    common = ["run", "transport", "--device", "cuda", "--n", "1024", "--Re", "1000", "--Pe",
              "1000", "--fused-predictor", "true", "--t-final", "1e9", "--chunk-steps", "50",
              "--snapshot-interval", "100", "--io", SNAPSHOT_IO]
    file = "snapshots.csnap" if SNAPSHOT_IO == "native" else "snapshots.h5"
    split, straight = SMOKE_OUT / "split" / file, SMOKE_OUT / "straight" / file
    _reset_counts()
    reports = [cli.main([*common, "--out", str(split.parent), "--max-steps", "200"]),
               cli.main([*common, "--out", str(split.parent), "--max-steps", "400", "--resume"])]
    launches = _counts()
    reports.append(cli.main([*common, "--out", str(straight.parent), "--max-steps", "400"]))
    if [r["final_step"] for r in reports] != [200, 400, 400] or any(
            r["chunk_route"] != "graph" or r["stopped_reason"] for r in reports):
        raise AssertionError(f"transport runs: {reports}")
    # two runs of 200 steps, each with its capture's 10 warm-up steps
    want = {"predictor": 420, "rbsor_a": 0, "rbsor_a_cooperative": 0, "rbsor_b": 0}
    if launches != want:
        raise AssertionError(f"transport path launches {launches}, expected {want}")
    snaps = {name: csnap_steps(path) for name, path in (("split", split),
                                                        ("straight", straight))}
    if any(sorted(s) != [0, 100, 200, 300, 400] for s in snaps.values()):
        raise AssertionError(f"snapshot steps {[sorted(s) for s in snaps.values()]}")
    (fa, ta), (fb, tb) = snaps["split"][400], snaps["straight"][400]
    differ = [k for k in fb if not np.array_equal(fa[k], fb[k])]
    # and as states: what a user would resume from
    template = build("transport", n=1024, Re=1000.0, Pe=1000.0, device="cuda")
    sa, sb = restore(template.state, split), restore(template.state, straight)
    differ += [k for (k, a), b in zip(named_leaves(sa), leaves(sb)) if not torch.equal(a, b)]
    hot = template.extras["hot_lid"]
    th_min, th_max = float(sa.theta.min()), float(sa.theta.max())
    say("transport_resume", n=1024, steps=400, fields=sorted(fb), bit_equal=not differ,
        differ=differ, t_split=ta, t_straight=tb, theta_min=th_min, theta_max=th_max,
        theta_mean=float(sa.theta.mean()), launches=launches, io=SNAPSHOT_IO,
        file_bytes=split.stat().st_size, reports=reports)
    if differ or ta != tb or sorted(fb) != ["p", "theta", "u", "v"] or int(sa.step) != 400:
        raise AssertionError(f"resume is not bit-exact: {differ}, t {ta} vs {tb}")
    if not (0.0 <= th_min and th_max <= hot):
        raise AssertionError(f"θ left [0, {hot}]: {th_min}, {th_max}")

    # seconds per snapshot at 1024² (u, v, p, θ: 16.8 MB): the call (device →
    # host copies and the queue's copy), then the drain (zlib on the
    # writer's thread, and the disk)
    fields = {k: v for k, v in (*sa.flow._asdict().items(), ("theta", sa.theta)) if v.ndim == 2}
    with NativeSnapshotWriter(SMOKE_OUT / "timing.csnap") as w:
        call_s = []
        for step in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w.save(step, 0.0, **fields)
            call_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        w.flush()
        drain_s = time.perf_counter() - t0
    say("time_snapshot", io="native", n=1024, fields=sorted(fields), save_call_s=call_s,
        drain_s_for_3=drain_s, file_bytes=(SMOKE_OUT / "timing.csnap").stat().st_size)
    return launches["predictor"]


def golden_signature(case, steps: int) -> dict:
    """Field L2/max checksums after ``steps`` steps (one captured chunk)
    and the metrics of one more step (the signature of
    tests/test_goldens.py)."""
    chunk = make_chunk(case.cfg, case.step, steps)
    if chunk.mode != "graph":
        raise AssertionError(f"the golden ran through the {chunk.mode} route")
    s, _ = chunk(case.state, 1.0)
    _, m = make_chunk(case.cfg, case.step, 1)(s, 1.0)
    sig = {}
    for name in s._fields:  # u, v, p; θ too on the Boussinesq state
        f = getattr(s, name)
        if f.ndim >= 2:
            sig[f"l2_{name}"] = float(torch.sqrt(torch.mean(f * f)))
            sig[f"max_{name}"] = float(f.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "nusselt", "q_body", "vort_max"):
        if hasattr(m, name):
            sig[name] = float(getattr(m, name)[-1])
    return sig


def golden_check(sig, ref, tols=None) -> dict:
    """The golden rule of tests/test_goldens.py:112-124 on ``sig``: RTOL
    2e-5 of each key, and 1e-6 of the largest key below that noise floor
    (``tols`` sets some keys' tolerances apart). Returns each key's |Δ|
    over its tolerance, and raises if one is beyond it."""
    atol = 1e-6 * max(abs(v) for v in ref.values())
    tol = {k: GOLDEN_RTOL * abs(w) if abs(w) > atol else atol for k, w in ref.items()}
    tol.update(tols or {})
    share = {k: abs(sig[k] - w) / tol[k] for k, w in ref.items()}
    beyond = {k: (sig[k], ref[k]) for k, v in share.items() if not v <= 1.0}
    if beyond:
        raise AssertionError(f"golden keys beyond the rule (got, want): {beyond}")
    return share


def phase_golden():
    ref = json.loads((ROOT / "tests" / "goldens.json").read_text())["cavity_collocated_48"]
    for fused in (False, True):
        sig = golden_signature(build("cavity", n=48, Re=100.0, fused_predictor=fused,
                                     device="cuda"), 300)
        share = golden_check(sig, ref)
        say("golden", fused_predictor=fused, keys=len(ref),
            worst_share_of_tol=max(share.values()), rtol=GOLDEN_RTOL)


def phase_main_path():
    pois = POISSON  # the bench's: dct_variant="auto", resolved when the step is built
    case = lid_cavity(n=1024, Re=1000.0, poisson=pois, compute_metrics=True,
                      fused_predictor=True, device="cuda")
    cfg = RunnerConfig(t_final=1e9, max_steps=600, chunk_steps=100, health_check=True,
                       div_threshold=50.0, max_velocity=case.cfg.max_velocity,
                       log_every_chunks=0)
    _reset_counts()
    t0 = time.perf_counter()
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    state, report = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = counts.pop("predictor")
    if any(counts.values()):
        raise AssertionError(f"the DCT main path launched RB-SOR kernels: {counts}")
    steps = int(state.step)
    finite = bool(torch.isfinite(state.u).all() and torch.isfinite(state.v).all()
                  and torch.isfinite(state.p).all())
    max_u = float(state.u.abs().max())
    say("main_path", n=1024, Re=1000.0, steps=steps, launches=launches, finite=finite,
        max_abs_u=max_u, t=report["final_time"], stopped_reason=report["stopped_reason"],
        last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim),
        device_peak_bytes=report.get("device_peak_bytes"))
    if report["stopped_reason"] or steps != 600:
        raise AssertionError(f"main path stopped early: {report['stopped_reason']!r} at {steps}")
    if not finite or not max_u <= 1.5:
        raise AssertionError(f"main path unhealthy: finite={finite} max|u|={max_u}")
    # one launch per step, counted by the kernel on the device: 600 steps
    # replayed from the graph and the capture's eager warm-up steps
    if launches != steps + sim.chunk.steps_per_graph or sim.chunk.mode != "graph":
        raise AssertionError(f"fused predictor launched {launches} times in {steps} steps "
                             f"(+{sim.chunk.steps_per_graph} of warm-up) on the "
                             f"{sim.chunk.mode} route")

    # a CFL back-off between two chunks: the host writes 0.25 into the
    # chunk's cfl buffer; dt follows (0.25 × 0.5 × h / max|u| is below the
    # viscous bound) and the program is the one captured before
    program = sim.chunk.program
    sim.cfl_scale = 0.25
    m_host, _ = sim._chunk(sim.cfl_scale)
    h = case.grid.dx
    want_dt = 0.25 * case.cfg.cfl_target * h / float(m_host.max_vel[-2])
    say("cfl_backoff", cfl_scale=0.25, dt_before=sim.metrics_history[-1]["dt"],
        dt_after=float(m_host.dt[-1]), dt_expected=want_dt,
        recaptured=sim.chunk.program is not program, replays=program.replays)
    if sim.chunk.program is not program or abs(float(m_host.dt[-1]) - want_dt) > 1e-3 * want_dt:
        raise AssertionError("the CFL back-off did not reach the captured chunk")
    state = sim.state

    # fused vs unfused from the same state (these launches are not counted)
    other = lid_cavity(n=1024, Re=1000.0, poisson=pois, compute_metrics=True,
                       fused_predictor=False, device="cuda")
    cfl = torch.ones((), dtype=torch.float32, device="cuda")
    sa = sb = state
    for _ in range(5):
        sa, _ = case.step(sa, cfl)
        sb, _ = other.step(sb, cfl)
    err = max(float((getattr(sa, k) - getattr(sb, k)).abs().max()) for k in ("u", "v"))
    say("fused_vs_unfused", steps=5, max_abs_err=err, atol=STEP_ATOL)
    if not err <= STEP_ATOL:
        raise AssertionError(f"fused and unfused steps differ by {err}")
    return launches


def phase_dct_variants(card):
    """Every DCT variant against rfft on the card; "auto" measured once,
    then read from the cache, never timed under a capture; each variant's
    device ms per shape and the winner. Returns the per-shape table."""
    rng = np.random.default_rng(11)
    checks = [(1024, v) for v in ("rfft2", "rfft_split", "rfft_split4", "rfft_split8", "packed",
                                  "matmul")] + [(4096, "rfft_split4"), (4096, "rfft_split8")]
    refs = {}
    for n, variant in checks:
        h = 1.0 / n
        if n not in refs:
            rhs = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device="cuda")
            refs[n] = (rhs, NeumannDCT((n, n), h, h, "rfft", device="cuda")(rhs))
        rhs, want = refs[n]
        got = NeumannDCT((n, n), h, h, variant, device="cuda")(rhs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / float(want.abs().max())
        say("dct_variant_vs_rfft", n=n, variant=variant, max_rel_err=err, rtol=DCT_VARIANT_RTOL)
        if not err <= DCT_VARIANT_RTOL:
            raise AssertionError(f"dct_variant {variant} at {n}²: {err} of max|φ|")
    del refs

    # "auto": a cache of this run's own; the first build measures, the second
    # reads the in-process cache, a fresh process the file; a capture never times
    cache_dir = SMOKE_OUT / "autotune"
    shutil.rmtree(cache_dir, ignore_errors=True)
    old_env = os.environ.get("CFDSIM_AUTOTUNE_CACHE")
    os.environ["CFDSIM_AUTOTUNE_CACHE"] = str(cache_dir)
    measured = []
    real_measure = autotune.measure_dct_variants

    def counting(*a, **k):
        measured.append(a[0])
        return real_measure(*a, **k)

    autotune.measure_dct_variants = counting
    try:
        autotune._MEM.clear()
        h = 1.0 / 1024
        t0 = time.perf_counter()
        first = PoissonSolver((1024, 1024), h, h, PoissonConfig(method="dct", dct_variant="auto"),
                              device="cuda").dct.variant
        tune_s = time.perf_counter() - t0
        second = PoissonSolver((1024, 1024), h, h, PoissonConfig(method="dct", dct_variant="auto"),
                               device="cuda").dct.variant
        autotune._MEM.clear()
        from_disk = autotune.best_dct_variant((1024, 1024), h, h, device="cuda")
        entry = json.loads((cache_dir / "autotune.json").read_text())
        # a MAC cavity with "auto" through the captured chunk: resolved at build
        case = lid_cavity_mac(n=1024, Re=1000.0, poisson=PoissonConfig(method="dct",
                                                                       dct_variant="auto"),
                              device="cuda")
        chunk = make_chunk(case.cfg, case.step, 10)
        chunk(case.state, 1.0)
        torch.cuda.synchronize()
        # a miss under a capture raises, and times nothing
        g = torch.cuda.CUDAGraph()
        refused = None
        with torch.cuda.graph(g):
            try:
                autotune.best_dct_variant((96, 160), 0.1, 0.1, device="cuda")
            except RuntimeError as e:
                refused = str(e)
    finally:
        autotune.measure_dct_variants = real_measure
        if old_env is None:
            os.environ.pop("CFDSIM_AUTOTUNE_CACHE", None)
        else:
            os.environ["CFDSIM_AUTOTUNE_CACHE"] = old_env
    say("dct_auto", n=1024, first=first, second=second, from_disk=from_disk,
        measurements=len(measured), tune_s=tune_s, cache=entry, chunk_route=chunk.mode,
        mac_step_variant=case.step.cfg.poisson.dct_variant, capture_refused=refused, card=card)
    if not (first == second == from_disk == case.step.cfg.poisson.dct_variant) or len(
            measured) != 1 or chunk.mode != "graph" or refused is None:
        raise AssertionError(f"auto: {first}, {second}, {from_disk}, measured {measured}, "
                             f"refused under capture: {refused!r}")

    # each variant's device ms by shape, and the winner
    table = {}
    for n in DCT_TIMING_SIZES:
        t = dct_solve_ms(n, reps=20 if n < 4096 else 5)
        table[n] = {"winner": t["winner"], **{k[:-len("_device_ms")]: min(v)
                                              for k, v in t.items() if k.endswith("_device_ms")}}
        say("time_dct_variants", **t, card=card)
        torch.cuda.empty_cache()
    return table


def phase_fdm_precision():
    """The stretched 512² FDM solve stays full float32 under a caller's
    "high" (TF32) matmul precision, and the caller's setting comes back."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        faces = mac_stretched.wall_clustered_faces(512, 1.0, beta=1.5)
        h = np.diff(faces)
        solver = fdm.make_fdm_solver(h, h, device="cuda")
        rng = np.random.default_rng(5)
        rhs = rng.standard_normal((512, 512))
        w = np.outer(h, h)
        rhs -= (w * rhs).sum() / w.sum()  # no nullspace component
        r = torch.tensor(rhs, dtype=torch.float32, device="cuda")
        L = torch.tensor(fdm.neumann_operator_1d(h), dtype=torch.float64, device="cuda")

        def rel_residual(phi):
            p = phi.double()
            res = L @ p + p @ L.T - r.double()
            return float(torch.linalg.norm(res) / torch.linalg.norm(r.double()))

        guarded = rel_residual(solver(r))
        after = torch.get_float32_matmul_precision()
        # the same four products without the guard, under the caller's "high"
        raw = solver.Vy @ ((solver.Vyi @ r @ solver.VxiT) * solver.inv_lam) @ solver.VxT
        unguarded = rel_residual(raw)
    finally:
        torch.set_float32_matmul_precision(before)
    say("fdm_precision", n=512, beta=1.5, precision_set="high", rel_residual=guarded,
        rel_residual_without_guard=unguarded, rtol=FDM_RESIDUAL_RTOL, precision_after=after)
    if not guarded <= FDM_RESIDUAL_RTOL or after != "high":
        raise AssertionError(f"FDM under 'high': residual {guarded}, precision after {after!r}")


def _mac_h(case):
    """The smallest spacing of a MAC case (stretched: of its faces)."""
    if "x_faces" in case.extras:
        return float(min(np.diff(case.extras["x_faces"]).min(),
                         np.diff(case.extras["y_faces"]).min()))
    return min(case.grid.dx, case.grid.dy)


# the staggered paths of phase_mac_paths: the mac_paths cell, the steps and
# the largest |u| a healthy run has
MAC_PATH_RUNS = {
    "cavity_mac1024_chorin": (200, 1.5),
    "cavity_mac1024_incremental": (200, 1.5),
    "cavity_mac1024_implicit": (200, 1.5),
    "cylinder_mac720x240": (200, 3.0),
    "cylinder_oscillating480x240": (200, 3.0),
    "cylinder_oscillating480x240_stretched": (200, 3.0),
    "cavity_stretched512": (200, 1.5),
    "cylinder_stretched512x256": (200, 3.0),
    "cylinder_mac720x240_ghost": (200, 3.0),
    "cylinder_oscillating480x240_ghost": (200, 3.0),
    "cylinder_oscillating480x240_stretched_ghost": (200, 3.0),
}


def phase_mac_paths():
    """Each staggered path from rest through runner.Simulation's captured
    chunks: healthy, no kernel launched (DCT or FDM projection), and div u
    at float32 roundoff after every step."""
    cases = mac_paths(1024, compute_metrics=True, device="cuda")
    for path, (steps, max_u) in MAC_PATH_RUNS.items():
        case = cases.pop(path)
        _reset_counts()
        sim, state, report, wall = _run(case, steps, 50, warmup_div_threshold=50.0)
        launches = _counts()
        _, got_u = _healthy(path, state, report, steps, max_u)
        h = _mac_h(case)
        div_post = max(r["div_post"] for r in sim.metrics_history)
        rtol = FDM_DIV_POST_RTOL if "x_faces" in case.extras else MAC_DIV_POST_RTOL
        bound = rtol * max(r["max_vel"] for r in sim.metrics_history) / h
        # the body force of one more step (not counted)
        _, m = case.step(state, torch.ones((), dtype=torch.float32, device="cuda"))
        fx, fy = float(m.fx), float(m.fy)
        say("mac_path", path=path, steps=int(state.step), launches=launches, max_abs_u=got_u,
            div_post_max=div_post, div_post_bound=bound, fx=fx, fy=fy, t=report["final_time"],
            last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim),
            device_peak_bytes=report.get("device_peak_bytes"))
        if any(launches.values()):
            raise AssertionError(f"{path} launched kernels: {launches}")
        if not (math.isfinite(fx) and math.isfinite(fy)):
            raise AssertionError(f"{path}: body force not finite: {fx}, {fy}")
        if not div_post <= bound:
            raise AssertionError(f"{path}: div_post {div_post} above roundoff {bound}")
    del cases
    torch.cuda.empty_cache()


def phase_mac_kernels():
    """The MAC tier's pressure solve through the RB-SOR kernels: the mg:2
    MAC cavity at 1024² (kernels A and B) against plain smoothing, and the
    MAC cylinder through kernel A."""
    steps = 100
    case = lid_cavity_mac(n=1024, Re=1000.0, poisson="mg:2", device="cuda")
    _reset_counts()
    sim, state, report, wall = _run(case, steps, 50)
    launches = _counts()
    _, max_u = _healthy("mac_mg_cavity", state, report, steps, 1.5)
    say("mac_mg_path", n=1024, Re=1000.0, steps=int(state.step), launches=launches,
        max_abs_u=max_u, t=report["final_time"], last_chunk=sim.metrics_history[-1],
        wall_s=wall, **_chunk_facts(sim))
    ran = steps + sim.chunk.steps_per_graph  # the pressure grid of phase_mg_cavity
    want = {"predictor": 0, "rbsor_a": ran * 2 * 14, "rbsor_a_cooperative": ran * 2 * 2,
            "rbsor_b": ran * 2 * 2}
    if launches != want:
        raise AssertionError(f"MAC multigrid path launches {launches}, expected {want}")
    plain = lid_cavity_mac(n=1024, Re=1000.0, device="cuda",
                           poisson=PoissonConfig(method="mg", iters=2, mg_pallas_smooth=False))
    diff = _steps_apart(case, plain, state, 5)
    say("mac_mg_kernel_vs_plain_smoothing", steps=5, **diff, uv_atol=MG_UV_ATOL)
    if not (diff["du"] <= MG_UV_ATOL and diff["dv"] <= MG_UV_ATOL):
        raise AssertionError(f"MAC multigrid kernel vs plain smoothing: {diff}")

    steps = 50
    cyl = build("cylinder_mac", poisson=CYLINDER_KERNEL_POISSON, device="cuda")
    chunks_run = cyl.step.poisson.chunks_run
    _reset_counts()
    chunks_run.zero_()
    sim, state, report, wall = _run(cyl, steps, 50)
    cyl_launches = _counts()
    _, max_u = _healthy("mac_cylinder_kernel_a", state, report, steps, 3.0)
    say("mac_cylinder_kernel_a_path", nx=720, ny=240, steps=int(state.step),
        launches=cyl_launches, kernel_chunks_run=int(chunks_run), max_abs_u=max_u,
        last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim))
    ran = steps + sim.chunk.steps_per_graph
    if cyl_launches != {"predictor": 0, "rbsor_a": ran, "rbsor_a_cooperative": 0, "rbsor_b": 0}:
        raise AssertionError(f"MAC cylinder through kernel A launched {cyl_launches}")
    return launches, cyl_launches


def phase_mac_goldens():
    for name, ((case_name, kw), steps) in MAC_GOLDENS.items():
        ref = json.loads((ROOT / "tests" / "goldens.json").read_text())[name]
        sig = golden_signature(build(case_name, device="cuda", **kw), steps)
        tols = {}
        if name == "cylinder_mac_forces":
            tols["fy"] = GOLDEN_RTOL * max(abs(ref["fx"]), abs(ref["fy"]))
            tols["max_p"] = GOLDEN_P_RTOL * abs(ref["max_p"])
        share = golden_check(sig, ref, tols)
        say("mac_golden", golden=name, share_of_tol=share, rtol=GOLDEN_RTOL,
            worst_share_of_tol=max(share.values()))


def phase_botella_peyret():
    """The accuracy gate of the MAC tier: 128², Re=1000, t = 200."""
    n = 128
    case = lid_cavity_mac(n=n, Re=1000.0, device="cuda")
    cfg = RunnerConfig(t_final=200.0, chunk_steps=2000, health_check=True, div_threshold=50.0,
                       max_velocity=case.cfg.max_velocity, log_every_chunks=0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    t0 = time.perf_counter()
    state, report = sim.run()
    wall = time.perf_counter() - t0
    if report["stopped_reason"] or report["chunk_route"] != "graph":
        raise AssertionError(f"B&P run: {report}")
    x = (np.arange(n) + 0.5) / n
    errs = botella_peyret_errors(state.u[:, n // 2].cpu().numpy(), x,
                                 state.v[n // 2, :].cpu().numpy(), x)
    say("botella_peyret_gate", n=n, Re=1000, t=report["final_time"], steps=report["final_step"],
        errors=errs, tol=BP_TOL, wall_s=wall)
    if not max(errs.values()) < BP_TOL:
        raise AssertionError(f"Botella–Peyret at 128²: {errs} (tol {BP_TOL})")


# the Boussinesq gates of tests/test_boussinesq.py:23 and :97: de Vahl Davis
# (48², Ra = 1e3, t = 0.6: both Nusselt numbers within 2% of 1.118, the
# largest velocity within 5% of 3.70) and the onset bracket at ny = 32
# (Ra = 1200 decays to max|u| < 1e-3 by t = 1; Ra = 3000 grows past 5 by t = 5
# with Nu > 1.3)
DVD_NU, DVD_NU_RTOL, DVD_VEL, DVD_VEL_RTOL = 1.118, 0.02, 3.70, 0.05


def _run_to(case, t_final, chunk_steps):
    """``case`` to ``t_final`` through runner.Simulation's captured chunks;
    the state and the metrics of one more step (not counted)."""
    cfg = RunnerConfig(t_final=t_final, chunk_steps=chunk_steps, health_check=True,
                       div_threshold=50.0, max_velocity=1e3, log_every_chunks=0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    t0 = time.perf_counter()
    state, report = sim.run()
    wall = time.perf_counter() - t0
    if report["stopped_reason"] or report["chunk_route"] != "graph":
        raise AssertionError(f"{case.name} to t = {t_final}: {report}")
    _, m = case.step(state, torch.ones((), dtype=torch.float32, device="cuda"))
    return state, m, report, wall


def phase_boussinesq():
    """The heated_cavity_32 golden, the de Vahl Davis gate, the onset
    bracket, and the 1024² heated cavity through the DCT and through mg:2
    (kernels A and B)."""
    name = "heated_cavity_32"
    ref = json.loads((ROOT / "tests" / "goldens.json").read_text())[name]
    sig = golden_signature(build("heated_cavity", n=32, Ra=1e4, device="cuda"), 300)
    share = golden_check(sig, ref)
    say("boussinesq_golden", golden=name, share_of_tol=share, rtol=GOLDEN_RTOL,
        worst_share_of_tol=max(share.values()))

    state, m, report, wall = _run_to(build("heated_cavity", n=48, Ra=1e3, device="cuda"),
                                     0.6, 500)
    nu_wall, nu_mid, vel = float(m.nu_hot_wall), float(m.nu_mid), float(m.max_vel)
    say("de_vahl_davis_gate", n=48, Ra=1e3, t=report["final_time"], steps=report["final_step"],
        nu_hot_wall=nu_wall, nu_mid=nu_mid, max_vel=vel, want_nu=DVD_NU, nu_rtol=DVD_NU_RTOL,
        want_max_vel=DVD_VEL, max_vel_rtol=DVD_VEL_RTOL, wall_s=wall)
    if not (abs(nu_wall - DVD_NU) <= DVD_NU_RTOL * DVD_NU
            and abs(nu_mid - DVD_NU) <= DVD_NU_RTOL * DVD_NU
            and abs(vel - DVD_VEL) <= DVD_VEL_RTOL * DVD_VEL):
        raise AssertionError(f"de Vahl Davis: Nu {nu_wall}, {nu_mid}, max velocity {vel}")

    bracket = {}
    for ra, t_end in ((1200.0, 1.0), (3000.0, 5.0)):
        _, m, report, wall = _run_to(build("rayleigh_benard", ny=32, aspect=2.0, Ra=ra,
                                           device="cuda"), t_end, 1000)
        bracket[ra] = dict(t=report["final_time"], steps=report["final_step"],
                           max_vel=float(m.max_vel), nu_hot_wall=float(m.nu_hot_wall),
                           nu_mid=float(m.nu_mid), wall_s=wall)
    say("rayleigh_benard_bracket", ny=32, aspect=2.0, runs=bracket)
    sub, sup = bracket[1200.0], bracket[3000.0]
    if not (sub["max_vel"] < 1e-3 and abs(sub["nu_hot_wall"] - 1.0) <= 1e-3):
        raise AssertionError(f"Ra = 1200 did not decay: {sub}")
    if not (sup["max_vel"] > 5.0 and sup["nu_hot_wall"] > 1.3
            and abs(sup["nu_hot_wall"] - sup["nu_mid"]) <= 0.02 * sup["nu_mid"]):
        raise AssertionError(f"Ra = 3000 did not convect: {sup}")

    steps = 100
    launches = {}
    for path, case in boussinesq_paths(1024, device="cuda").items():
        _reset_counts()
        sim, state, report, wall = _run(case, steps, 50)
        launches[path] = _counts()
        _, got_u = _healthy(path, state, report, steps, 100.0)
        div_post = max(r["div_post"] for r in sim.metrics_history)
        say("boussinesq_path", path=path, Ra=1e4, steps=int(state.step),
            launches=launches[path], max_abs_u=got_u, div_post_max=div_post,
            max_abs_p=float(state.p.abs().max()),
            theta_min=float(state.theta.min()), theta_max=float(state.theta.max()),
            t=report["final_time"], last_chunk=sim.metrics_history[-1], wall_s=wall,
            **_chunk_facts(sim), device_peak_bytes=report.get("device_peak_bytes"))
        ran = steps + sim.chunk.steps_per_graph
        if path.endswith("_mg2"):  # the pressure grid of phase_mg_cavity
            want = {"predictor": 0, "rbsor_a": ran * 2 * 14, "rbsor_a_cooperative": ran * 2 * 2,
                    "rbsor_b": ran * 2 * 2}
        else:
            want = {"predictor": 0, "rbsor_a": 0, "rbsor_a_cooperative": 0, "rbsor_b": 0}
            # the exact projection's roundoff scales with what it subtracts:
            # from rest that is the hydrostatic pressure balancing the
            # buoyancy (max|p| ~ Ra·Pr), of which u is a small remainder, so
            # the MAC bound takes the larger of max|u| and dt·max|p|/h
            h = case.grid.dx
            scale = max(max(r["max_vel"] for r in sim.metrics_history),
                        sim.metrics_history[-1]["dt"] * float(state.p.abs().max()) / h)
            bound = MAC_DIV_POST_RTOL * scale / h
            if not div_post <= bound:
                raise AssertionError(f"{path}: div_post {div_post} above roundoff {bound}")
        if launches[path] != want:
            raise AssertionError(f"{path} launched {launches[path]}, expected {want}")
    return launches["heated_cavity1024_mg2"]


def phase_3d():
    """Both 3D cavities at 256³ (BASELINE.json config 5), and a bit-exact
    native-snapshot resume of the MAC one at 128³ through the command line."""
    steps = 100
    for path, case in threed_paths(256, compute_metrics=True, device="cuda").items():
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        # from rest the collocated cavity's approximate projection leaves
        # the lid's divergence, which scales with 1/h, for the MG to reduce
        sim, state, report, wall = _run(case, steps, 50, warmup_div_threshold=1e4)
        launches = _counts()
        _, got_u = _healthy(path, state, report, steps, 1.5)
        div_post = max(r["div_post"] for r in sim.metrics_history)
        bound = MAC_DIV_POST_RTOL * max(r["max_vel"] for r in sim.metrics_history) * 256
        say("threed_path", path=path, n=256, steps=int(state.step), launches=launches,
            max_abs_u=got_u, min_u=float(state.u.min()), div_post_max=div_post,
            div_post_bound=bound if "mac" in path else None, t=report["final_time"],
            last_chunk=sim.metrics_history[-1], wall_s=wall, **_chunk_facts(sim),
            device_peak_bytes=torch.cuda.max_memory_allocated())
        if any(launches.values()):
            raise AssertionError(f"{path} launched kernels: {launches}")
        if "mac" in path and not div_post <= bound:
            raise AssertionError(f"{path}: div_post {div_post} above roundoff {bound}")
        del sim, state, case
        torch.cuda.empty_cache()

    out = SMOKE_OUT / "cavity3d_mac"
    shutil.rmtree(out, ignore_errors=True)
    common = ["run", "cavity3d_mac", "--device", "cuda", "--n", "128", "--t-final", "1e9",
              "--chunk-steps", "25", "--snapshot-interval", "50", "--io", SNAPSHOT_IO]
    reports = [cli.main([*common, "--out", str(out / "split"), "--max-steps", "50"]),
               cli.main([*common, "--out", str(out / "split"), "--max-steps", "100",
                         "--resume"]),
               cli.main([*common, "--out", str(out / "straight"), "--max-steps", "100"])]
    if [r["final_step"] for r in reports] != [50, 100, 100] or any(
            r["chunk_route"] != "graph" or r["stopped_reason"] for r in reports):
        raise AssertionError(f"cavity3d_mac runs: {reports}")
    a = csnap_steps(out / "split" / "snapshots.csnap")
    b = csnap_steps(out / "straight" / "snapshots.csnap")
    (fa, ta), (fb, tb) = a[100], b[100]
    differ = [k for k in fb if not np.array_equal(fa[k], fb[k])]
    template = build("cavity3d_mac", n=128, device="cuda")
    sa = restore(template.state, out / "split" / "snapshots.csnap")
    sb = restore(template.state, out / "straight" / "snapshots.csnap")
    differ += [k for (k, x), y in zip(named_leaves(sa), leaves(sb)) if not torch.equal(x, y)]
    say("threed_resume", case="cavity3d_mac", n=128, steps=100, snapshots=sorted(a),
        fields={k: list(v.shape) for k, v in fb.items()}, bit_equal=not differ, differ=differ,
        t_split=ta, t_straight=tb, io=SNAPSHOT_IO, reports=reports)
    if differ or ta != tb or not sorted(a) == sorted(b) == [0, 50, 100] or int(sa.step) != 100:
        raise AssertionError(f"3D resume is not bit-exact: {differ}, t {ta} vs {tb}")


def phase_3d_bodies(card):
    """The 3D bodies: both goldens; the Re = 100 ghost-sphere drag gate at
    192×96×96; the heated cube's Nusselt gate at 48³; each full-width body
    path from its start through runner.Simulation (healthy, no kernel
    launched; the dynamic coefficient printed), with its profile and peak
    memory."""
    ref_all = json.loads((ROOT / "tests" / "goldens.json").read_text())
    for name, ((case_name, kw), steps) in BODY_GOLDENS.items():
        sig = golden_signature(build(case_name, device="cuda", **kw), steps)
        share = golden_check(sig, ref_all[name])
        say("body_golden", golden=name, steps=steps, share_of_tol=share,
            worst_share_of_tol=max(share.values()), rtol=GOLDEN_RTOL, signature=sig)

    # the drag gate: a steady Re = 100 wake behind the ghost-cell sphere
    case = build("sphere_stretched", Re=100.0, ibm_scheme="ghost", ibm_ramp_steps=100,
                 device="cuda")
    _reset_counts()
    state, m, report, wall = _run_to(case, DRAG_T_FINAL, 100)
    cs = case.extras["coeff_scale"]
    cd, fx, fy, fz = cs * float(m.fx), float(m.fx), float(m.fy), float(m.fz)
    cd_sn = sphere_drag_schiller_naumann(100.0)
    say("sphere_drag_gate", nx=192, ny=96, nz=96, Re=100.0, t=report["final_time"],
        steps=report["final_step"], cd=cd, cd_schiller_naumann=cd_sn, rel_err=cd / cd_sn - 1,
        rtol=DRAG_RTOL, fx=fx, fy=fy, fz=fz, cells_per_d=1.0 / case.extras["h_min"],
        launches=_counts(), wall_s=wall, card=card)
    if not (abs(cd - cd_sn) <= DRAG_RTOL * cd_sn and abs(fy) < LATERAL_RTOL * fx
            and abs(fz) < LATERAL_RTOL * fx):
        raise AssertionError(f"sphere drag gate: Cd {cd} (Schiller–Naumann {cd_sn}), "
                             f"fy {fy}, fz {fz}")
    del case, state
    torch.cuda.empty_cache()

    # the heat gate: the differentially heated cube at Ra = 1e4
    state, m, report, wall = _run_to(build("heated_cube", n=48, Ra=1e4, device="cuda"),
                                     CUBE_T_FINAL, 500)
    nu_wall, nu_mid = float(m.nu_hot_wall), float(m.nu_mid)
    th_lo, th_hi = float(m.theta_min), float(m.theta_max)
    say("heated_cube_gate", n=48, Ra=1e4, t=report["final_time"], steps=report["final_step"],
        nu_hot_wall=nu_wall, nu_mid=nu_mid, want_nu=CUBE_NU, nu_rtol=CUBE_NU_RTOL,
        theta_min=th_lo, theta_max=th_hi, div_post=float(m.div_post), wall_s=wall, card=card)
    if not (abs(nu_wall - CUBE_NU) <= CUBE_NU_RTOL * CUBE_NU
            and abs(nu_wall - nu_mid) <= CUBE_BALANCE_RTOL * nu_mid
            and th_lo > -1e-3 and th_hi < 1.0 + 1e-3):
        raise AssertionError(f"heated cube: Nu {nu_wall}, {nu_mid}, θ in [{th_lo}, {th_hi}]")

    # the full-width cells: healthy from their start, then their profile
    for path, case in sphere_paths(compute_metrics=True, device="cuda").items():
        dynamic = getattr(case.step.cfg, "les_model", None) == "dynamic"
        steps = DYNAMIC_LES_STEPS if dynamic else BODY_PATH_STEPS
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        sim, state, report, wall = _run(case, steps, 50)
        peak = torch.cuda.max_memory_allocated()
        launches = _counts()
        _, got_u = _healthy(path, state, report, steps, BODY_PATH_MAX_U)
        extra = {}
        step = case.step
        if dynamic:
            u, v, w = state.u, state.v, state.w
            cs2 = dynamic_cs2_3d(0.5 * (u[:, :, 1:] + u[:, :, :-1]),
                                 0.5 * (v[:, 1:, :] + v[:, :-1, :]), 0.5 * (w[1:] + w[:-1]),
                                 step.inv_g2x, step.inv_g2y, step.inv_g2z, step.delta2,
                                 mask=step.les_fluid_mask)
            extra["dynamic_cs2"] = float(cs2)
            extra["dynamic_cs"] = math.sqrt(float(cs2))
        _, m = case.step(state, torch.ones((), dtype=torch.float32, device="cuda"))
        for f in ("fx", "fy", "fz", "nusselt"):
            if hasattr(m, f):
                extra[f] = float(getattr(m, f))
        profile = profile_chunk(case, 10, "cuda", card, None, path=path)
        say("body_path", path=path, steps=int(state.step), launches=launches, max_abs_u=got_u,
            t=report["final_time"], last_chunk=sim.metrics_history[-1], wall_s=wall,
            device_peak_bytes=peak, **extra, **_chunk_facts(sim),
            profile={k: profile[k] for k in ("device_events_per_step",
                                             "device_busy_ms_per_step", "wall_ms_per_step",
                                             "device_idle_share", "nodes")}, card=card)
        if any(launches.values()):
            raise AssertionError(f"{path} launched kernels: {launches}")
        if not all(math.isfinite(v) for v in extra.values()):
            raise AssertionError(f"{path}: non-finite diagnostics {extra}")
        del sim, state, case
        torch.cuda.empty_cache()


def _sod_tube(nx: int):
    """The Sod tube of tests/test_compressible.py:62 (transmissive x, uniform
    y, HLLC + MUSCL, CFL 0.4) on the card."""
    grid = Grid(nx=nx, ny=8, x_max=1.0, y_max=0.04, centering="cell")
    cfg = comp.CompressibleConfig(grid=grid, flux="hllc", reconstruction="muscl", cfl=0.4)
    left = torch.tensor(grid.x_coords() < 0.5, device="cuda")[None, :].expand(8, nx)
    rho = torch.where(left, 1.0, 0.125)
    p = torch.where(left, 1.0, 0.1)
    zero = torch.zeros_like(rho)

    def bc(U, step, t):
        U = U.clone()
        U[:, :, 0] = U[:, :, 1]
        U[:, :, -1] = U[:, :, -2]
        U[:, 0, :] = U[:, 1, :]
        U[:, -1, :] = U[:, -2, :]
        return U

    state = comp.CompressibleState(U=comp.prim_to_cons(rho, zero, zero, p, 1.4),
                                   t=torch.zeros((), device="cuda"),
                                   step=torch.zeros((), dtype=torch.int32, device="cuda"))
    return cfg, comp.make_step(cfg, bc, device="cuda"), state


def _chunks_to(cfg, step, state, t_end, chunk_steps):
    """Captured chunks of ``chunk_steps`` until t ≥ ``t_end`` (the JAX tests'
    loop: the last chunk may pass it)."""
    chunk = make_chunk(cfg, step, chunk_steps)
    if chunk.mode != "graph":
        raise AssertionError(f"{chunk.mode} route: {chunk.reason}")
    while float(state.t) < t_end:
        state, m = chunk(state, 1.0)
    return state, m


def _wedge_gate(state, grid):
    """β from the shock fit of tests/test_compressible.py:232-263 (the ρ
    mid-level crossing above the wall for 0.7 ≤ x ≤ 1.4, plus the frame's
    10°) and the post-shock state at x = 1.3, y = 0.08."""
    rho = state.U[0].cpu().numpy()
    X, Y = grid.x_coords(), grid.y_coords()
    mid = 0.5 * (1.0 + RHO2)
    xs, ys = [], []
    for j in range(len(X)):
        if not (0.7 <= X[j] <= 1.4):
            continue
        above = np.where(rho[:, j] > mid)[0]
        if not len(above) or above.max() + 1 >= len(Y):
            continue
        i = above.max()
        f = (rho[i, j] - mid) / (rho[i, j] - rho[i + 1, j] + 1e-12)
        xs.append(X[j])
        ys.append(Y[i] + f * (Y[i + 1] - Y[i]))
    beta = float(np.degrees(np.arctan(np.polyfit(xs, ys, 1)[0])) + 10.0)
    r, u, v, p = (a.cpu().numpy() for a in cons_to_prim(state.U, 1.4))
    jj, ii = int(np.argmin(np.abs(X - 1.3))), int(np.argmin(np.abs(Y - 0.08)))
    return beta, float(r[ii, jj]), float(p[ii, jj]), float(v[ii, jj])


def phase_compressible(card):
    """The compressible goldens, the Sod star states, the θ-β-M gate at
    400×200, each 2D cell at its reference size through runner.Simulation
    (the compressible health check) and its steps/s, the blast's gates at
    64³ and its 256³ cell with peak memory."""
    ref_all = json.loads((ROOT / "tests" / "goldens.json").read_text())
    for name, ((case_name, kw), steps) in COMPRESSIBLE_GOLDENS.items():
        sig = golden_signature(build(case_name, device="cuda", **kw), steps)
        share = golden_check(sig, ref_all[name])
        say("compressible_golden", golden=name, steps=steps, share_of_tol=share,
            worst_share_of_tol=max(share.values()), rtol=GOLDEN_RTOL, signature=sig)

    cfg, step, state = _sod_tube(400)
    state, _ = _chunks_to(cfg, step, state, 0.2, 50)
    r, u, _, p = (a[4].cpu().numpy() for a in cons_to_prim(state.U, 1.4))
    x = cfg.grid.x_coords()

    def mean_in(lo, hi, f):
        return float(f[(x > lo) & (x < hi)].mean())

    got = {"rho_left": mean_in(0.55, 0.65, r), "rho_right": mean_in(0.72, 0.82, r),
           "p": mean_in(0.58, 0.78, p), "u": mean_in(0.58, 0.78, u)}
    rel = {k: got[k] / SOD_STAR[k] - 1 for k in got}
    say("sod_star_states", nx=cfg.grid.nx, t=float(state.t), got=got, want=SOD_STAR, rel_err=rel,
        rtol=SOD_RTOL)
    if not all(abs(e) <= SOD_RTOL for e in rel.values()):
        raise AssertionError(f"Sod star states {got}")

    case = build("wedge", frame="wedge_aligned", flux="hllc", reconstruction="muscl",
                 device="cuda")
    t0 = time.perf_counter()
    state, _ = _chunks_to(case.cfg, case.step, case.state, 2.5, 200)
    wall = time.perf_counter() - t0
    beta, rho2, p2, v2 = _wedge_gate(state, case.grid)
    say("theta_beta_mach_gate", nx=case.grid.nx, ny=case.grid.ny, t=float(state.t),
        steps=int(state.step), beta_deg=beta, want_beta_deg=BETA_DEG, rho2=rho2, want_rho2=RHO2, p2=p2, want_p2=P2,
        v2=v2, wall_s=wall, card=card)
    if not (abs(beta - BETA_DEG) <= BETA_TOL_DEG and abs(rho2 / RHO2 - 1) <= JUMP_RTOL
            and abs(p2 / P2 - 1) <= JUMP_RTOL and abs(v2) < V_MAX):
        raise AssertionError(f"θ-β-M: β {beta}, ρ₂ {rho2}, p₂ {p2}, v {v2}")

    # each path with its metrics on (the health check reads them), then its
    # steps/s with them off, as the bench times it
    paths = compressible_paths(compute_metrics=True, device="cuda")
    timed = compressible_paths(device="cuda")
    blast = {k: timed.pop(k) for k in list(timed) if k.startswith("blast3d")}
    for path, case in timed.items():
        case_on = paths[path]
        steps = COMPRESSIBLE_PATH_STEPS
        cfg = RunnerConfig(t_final=1e9, max_steps=steps, chunk_steps=100, log_every_chunks=0)
        sim = Simulation(case_on.step, case_on.state, cfg, case.grid.n_cells,
                         health_fn=lambda m, step: check_compressible(m))
        _reset_counts()
        t0 = time.perf_counter()
        state, report = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        if report["stopped_reason"] or int(state.step) != steps or sim.chunk.mode != "graph":
            raise AssertionError(f"{path}: {report}")
        if not bool(torch.isfinite(state.U).all()) or any(launches.values()):
            raise AssertionError(f"{path}: finite {bool(torch.isfinite(state.U).all())}, "
                                 f"launches {launches}")
        rate = cells_per_sec(case, case.grid.n_cells, short=50, long=250)
        steps_per_s = 1e3 / rate["ms_per_step"]
        extra = {}
        if path.startswith("cavity"):
            extra = {"target_steps_per_s": CAVITY_TARGET_STEPS_PER_S,
                     "over_target": steps_per_s / CAVITY_TARGET_STEPS_PER_S}
        say("compressible_path", path=path, shape=list(case.grid.shape), steps=steps,
            t=report["final_time"], last_chunk=sim.metrics_history[-1], wall_s=wall,
            steps_per_s=steps_per_s, cells_per_s=rate["value"], ms_per_step=rate["ms_per_step"],
            **extra, **_chunk_facts(sim), card=card)
        del sim, state, case, case_on
        torch.cuda.empty_cache()

    case = build("blast3d", n=BLAST_GATE_N, device="cuda")
    U0 = case.state.U
    mass0, e0 = (float(U0[c, 1:-1, 1:-1, 1:-1].double().sum()) for c in (0, 4))
    state, _ = make_chunk(case.cfg, case.step, BLAST_GATE_STEPS)(case.state, 1.0)
    mass1, e1 = (float(state.U[c, 1:-1, 1:-1, 1:-1].double().sum()) for c in (0, 4))
    rho = state.U[0].cpu().numpy()
    c = BLAST_GATE_N // 2
    axis_gap = max(float(np.abs(rho[c, c, :] - rho[c, :, c]).max()),
                   float(np.abs(rho[c, c, :] - rho[:, c, c]).max()))
    say("blast3d_gate", n=BLAST_GATE_N, steps=BLAST_GATE_STEPS, t=float(state.t),
        mass_rel=mass1 / mass0 - 1, energy_rel=e1 / e0 - 1, axis_profile_gap=axis_gap,
        rtol=BLAST_RTOL, axis_tol=BLAST_AXIS_TOL)
    if not (abs(mass1 / mass0 - 1) <= BLAST_RTOL and abs(e1 / e0 - 1) <= BLAST_RTOL
            and axis_gap < BLAST_AXIS_TOL and bool(torch.isfinite(state.U).all())):
        raise AssertionError(f"blast3d gate: mass {mass1 / mass0 - 1}, energy "
                             f"{e1 / e0 - 1}, axis gap {axis_gap}")
    del case, state
    for path, case in blast.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        rate = cells_per_sec(case, case.grid.n_cells, short=5, long=15)
        say("compressible_path", path=path, shape=list(case.grid.shape),
            steps_per_s=1e3 / rate["ms_per_step"], cells_per_s=rate["value"],
            ms_per_step=rate["ms_per_step"], device_peak_bytes=torch.cuda.max_memory_allocated(),
            state_bytes=case.state.U.numel() * 4, launches=_counts(),
            **{k: rate[k] for k in ("route", "nodes", "capture_s")}, card=card)
        del case
    torch.cuda.empty_cache()


def phase_spectral(card):
    """The reference's Kolmogorov run at 640×360 on both traces, the
    pseudo-spectral cells at 512² and 1024², and the pseudo-spectral gates:
    the inviscid Taylor–Green energy and the forced laminar profile."""
    paths = spectral_paths(compute_metrics=True, device="cuda")
    for path, case in spectral_paths(device="cuda").items():
        steps = KOLMOGOROV_STEPS if path.startswith("kolmogorov640") else 500
        cfg = RunnerConfig(t_final=1e9, max_steps=steps, chunk_steps=50, log_every_chunks=0)
        case_on = paths.pop(path)
        sim = Simulation(case_on.step, case_on.state, cfg, case.grid.n_cells)
        _reset_counts()
        t0 = time.perf_counter()
        state, report = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        finite = all(bool(torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all())
                     for x in leaves(state))
        if report["stopped_reason"] or int(state.step) != steps or sim.chunk.mode != "graph":
            raise AssertionError(f"{path}: {report}")
        if not finite or any(launches.values()):
            raise AssertionError(f"{path}: finite {finite}, launches {launches}")
        rate = cells_per_sec(case, case.grid.n_cells, short=50, long=250)
        say("spectral_path", path=path, shape=list(case.grid.shape), steps=steps,
            t=report["final_time"], last_chunk=sim.metrics_history[-1],
            run_wall_s=wall, run_steps_per_s=steps / wall,
            steps_per_s=1e3 / rate["ms_per_step"], cells_per_s=rate["value"],
            ms_per_step=rate["ms_per_step"], **_chunk_facts(sim), card=card)
        del sim, state, case, case_on
        torch.cuda.empty_cache()

    cfg = ps.PseudoSpectralConfig(ny=TG_N, aspect=1.0, nu=0.0, dt=2e-3, forcing_scale=0.0)
    y, x = np.meshgrid(np.arange(TG_N) / TG_N, np.arange(TG_N) / TG_N, indexing="ij")
    k = 2 * np.pi * 4
    s0 = ps.init_state(cfg, w0=-2 * k * np.sin(k * x) * np.sin(k * y), device="cuda")
    e0 = sum(float((a.double() ** 2).mean()) for a in ps.velocities(cfg, s0))
    s, _ = make_chunk(cfg, ps.make_step(cfg, device="cuda"), TG_STEPS)(s0, 1.0)
    e1 = sum(float((a.double() ** 2).mean()) for a in ps.velocities(cfg, s))
    say("ps_taylor_green_gate", n=TG_N, steps=TG_STEPS, e0=e0, e1=e1, rel=e1 / e0 - 1,
        rtol=TG_RTOL)
    if not abs(e1 / e0 - 1) < TG_RTOL:
        raise AssertionError(f"Taylor–Green energy {e0} → {e1}")

    kf, nu, alpha, fs = 8, 1e-3, 0.5, 0.05
    cfg = ps.PseudoSpectralConfig(ny=FIXED_N, aspect=1.0, nu=nu, dt=2e-3, forcing_wavenumber=kf,
                                  forcing_scale=fs, linear_friction=alpha)
    s, _ = make_chunk(cfg, ps.make_step(cfg, device="cuda"), FIXED_STEPS)(
        ps.init_state(cfg, device="cuda"), 1.0)
    u, v = ps.velocities(cfg, s)
    u_star = fs / (nu * (np.pi * kf) ** 2 + alpha)
    u_max, v_max = float(u.abs().max()), float(v.abs().max())
    say("ps_laminar_fixed_point_gate", n=FIXED_N, steps=FIXED_STEPS, t=float(s.t),
        u_max=u_max, u_star=u_star, rel=u_max / u_star - 1, v_max=v_max, rtol=FIXED_RTOL)
    if not (abs(u_max / u_star - 1) <= FIXED_RTOL and v_max < FIXED_V * u_star):
        raise AssertionError(f"laminar fixed point: max|u| {u_max} (u* {u_star}), max|v| {v_max}")


def phase_new_tiers_resume():
    """One compressible case (the wedge-aligned 400×200) and one
    pseudo-spectral case (1024²) through the command line's ``run`` with
    native snapshots: a run and a ``--resume`` against one run, bit for bit;
    the ω̂ records are the JAX package's float32 planes."""
    for case_name, args, shape, field in (
            ("wedge", ["--frame", "wedge_aligned", "--reconstruction", "muscl"],
             {"U": [4, 200, 400]}, "U"),
            ("kolmogorov_ps", ["--ny", "1024", "--noise", "0.1"],
             {"w_hat": [2, 1024, 513]}, "w_hat")):
        out = SMOKE_OUT / case_name
        shutil.rmtree(out, ignore_errors=True)
        common = ["run", case_name, *args, "--device", "cuda", "--t-final", "1e9",
                  "--chunk-steps", "50", "--snapshot-interval", "100", "--io", SNAPSHOT_IO]
        reports = [cli.main([*common, "--out", str(out / "split"), "--max-steps", "100"]),
                   cli.main([*common, "--out", str(out / "split"), "--max-steps", "200",
                             "--resume"]),
                   cli.main([*common, "--out", str(out / "straight"), "--max-steps", "200"])]
        if [r["final_step"] for r in reports] != [100, 200, 200] or any(
                r["chunk_route"] != "graph" or r["stopped_reason"] for r in reports):
            raise AssertionError(f"{case_name} runs: {reports}")
        a = csnap_steps(out / "split" / "snapshots.csnap")
        b = csnap_steps(out / "straight" / "snapshots.csnap")
        (fa, ta), (fb, tb) = a[200], b[200]
        differ = [k for k in fb if not np.array_equal(fa[k], fb[k])]
        template = build(case_name, device="cuda", **cli._extra_kwargs(args))
        sa = restore(template.state, out / "split" / "snapshots.csnap")
        sb = restore(template.state, out / "straight" / "snapshots.csnap")
        differ += [k for (k, x), y in zip(named_leaves(sa), leaves(sb)) if not torch.equal(x, y)]
        fields = {k: list(v.shape) for k, v in fb.items()}
        say("new_tier_resume", case=case_name, steps=200, snapshots=sorted(a), fields=fields,
            dtype=str(fb[field].dtype), bit_equal=not differ, differ=differ, t_split=ta,
            t_straight=tb, io=SNAPSHOT_IO, reports=reports)
        if (differ or ta != tb or not sorted(a) == sorted(b) == [0, 100, 200]
                or fields != shape or fb[field].dtype != np.float32 or int(sa.step) != 200):
            raise AssertionError(f"{case_name} resume: {differ}, t {ta} vs {tb}, {fields}")


def _st_coefficients(cd, cl, dt, t_tail, diameter, u_mean):
    """examples/schafer_turek_2d2.py:78-100: the tail's mean and largest Cd,
    the Strouhal number from the lift's FFT (dominant bin) and from its zero
    crossings, and the Cl amplitude, over t > ``t_tail``."""
    t = dt * np.arange(1, len(cd) + 1)
    tail = t > t_tail
    clt = cl[tail] - cl[tail].mean()
    spec = np.abs(np.fft.rfft(clt))
    f_fft = np.fft.rfftfreq(len(clt), dt)[1:][np.argmax(spec[1:])]
    zc = np.where(np.diff(np.signbit(clt)))[0]
    f_zc = 0.5 * (len(zc) - 1) / (dt * (zc[-1] - zc[0])) if len(zc) > 2 else float("nan")
    return {"cd": float(cd[tail].mean()), "cd_max": float(cd[tail].max()),
            "st_fft": float(f_fft * diameter / u_mean),
            "st_zc": float(f_zc * diameter / u_mean),
            "cl_amp": float(0.5 * (cl[tail].max() - cl[tail].min())),
            "cd_last": float(cd[-1]), "tail_steps": int(tail.sum())}


def phase_fem(card):
    """The unstructured FEM tier on the card: the bench cells' profiles, the
    reproducibility of the projection step, the Schäfer–Turek 2D-2 gate and
    the FEM Ghia gate. None of the three kernels runs here."""
    _reset_counts()
    # (a) the bench cells (bench.fem_paths): events, busy and wall ms, idle
    # share, and matvecs and host reads per step over the profile's runs
    # (a warm-up, a timed run, a profiled run)
    for path, case in fem_paths("cuda").items():
        case.step.counts.clear()
        row = profile_chunk(case, FEM_PROFILE_STEPS, "cuda", card, path=path)
        steps = 3 * FEM_PROFILE_STEPS
        say("fem_path", n_tris=case.extras["mesh"].n_tris, n_u=case.extras["ops"].n_u,
            n_p=case.extras["ops"].n_p, steps_per_s=1e3 / row["wall_ms_per_step"],
            **{f"{k}_per_step": v / steps for k, v in sorted(case.step.counts.items())}, **row)
        del case
    torch.cuda.empty_cache()

    # (d) twenty projection steps of the Schäfer–Turek case, twice from its
    # initial state: the same bits (a fixed-order scatter, no atomics)
    t0 = time.perf_counter()
    case = build("schafer_turek_fem", **ST_CONFIG, device="cuda")
    build_s = time.perf_counter() - t0
    repro = make_chunk(case.cfg, case.step, FEM_REPRO_STEPS)
    a, ma = repro(case.state, 1.0)
    b, mb = repro(case.state, 1.0)
    differ = [name for (name, x), y in zip(named_leaves(a) + named_leaves(ma),
                                           leaves(b) + leaves(mb)) if not torch.equal(x, y)]
    say("fem_reproducible", steps=FEM_REPRO_STEPS, n_tris=case.extras["mesh"].n_tris,
        build_s=build_s, bit_equal=not differ, differ=differ)
    if differ:
        raise AssertionError(f"projection steps not reproducible: {differ}")

    # (b) the Schäfer–Turek 2D-2 gate
    chunk = make_chunk(case.cfg, case.step, ST_CHUNK)
    dt, coeff = case.cfg.dt, case.extras["coeff_scale"]
    (t_final, t_tail), state, fx, fy = ST_RUNS[0], case.state, [], []
    case.step.counts.clear()
    t0 = time.perf_counter()
    while len(fx) * ST_CHUNK < round(t_final / dt):
        state, m = chunk(state, 1.0)
        fx.append(m.fx.cpu().numpy())
        fy.append(m.fy.cpu().numpy())
        if len(fx) == 5:  # 250 steps: the rate decides the run's length
            per_step = (time.perf_counter() - t0) / (5 * ST_CHUNK)
            if per_step * round(t_final / dt) > ST_BUDGET_S:
                t_final, t_tail = ST_RUNS[1]
    run_s = time.perf_counter() - t0
    n_steps = len(fx) * ST_CHUNK
    if not all(bool(torch.isfinite(x).all()) for x in leaves(state)):
        raise AssertionError("Schäfer–Turek: non-finite state")
    cd, cl = coeff * np.concatenate(fx), coeff * np.concatenate(fy)
    got = _st_coefficients(cd, cl, dt, t_tail, case.extras["diameter"], case.extras["u_mean"])
    ok = (ST_CD_MAX[0] <= got["cd_max"] <= ST_CD_MAX[1]
          and abs(got["cd"] / ST_CD_MEAN - 1) <= ST_CD_MEAN_RTOL
          and ST_ST[0] <= got["st_fft"] <= ST_ST[1]
          and abs(got["cl_amp"] / ST_CL_AMP - 1) <= ST_CL_RTOL)
    say("fem_schafer_turek_gate", t_final=t_final, t_tail=t_tail, steps=n_steps,
        n_tris=case.extras["mesh"].n_tris, **got, cd_max_band=ST_CD_MAX, cd_mean_ref=ST_CD_MEAN,
        cd_mean_rtol=ST_CD_MEAN_RTOL, st_band=ST_ST, cl_amp_ref=ST_CL_AMP,
        cl_rtol=ST_CL_RTOL, run_s=run_s, ms_per_step=run_s / n_steps * 1e3,
        **{f"{k}_per_step": v / n_steps for k, v in sorted(case.step.counts.items())},
        last_poisson_res=float(m.poisson_res[-1]), card=card)
    if not ok:
        raise AssertionError(f"Schäfer–Turek 2D-2 outside its bands: {got}")
    del case, state, chunk
    torch.cuda.empty_cache()

    # (c) the FEM Ghia gate
    case = build("cavity_fem", n=32, Re=100.0, dt=0.1, device="cuda")
    state, m = make_chunk(case.cfg, case.step, FEM_GHIA_STEPS)(case.state, 1.0)
    sp = case.extras["spaces"]
    tu = point_sampler(sp, np.stack([0.5 * np.ones_like(GHIA_Y), GHIA_Y], axis=1), device="cuda")
    tv = point_sampler(sp, np.stack([GHIA_X, 0.5 * np.ones_like(GHIA_X)], axis=1), device="cuda")
    u_c = sample_fields(tu, state.u)["u"].cpu().numpy().ravel()
    v_c = sample_fields(tv, state.u)["v"].cpu().numpy().ravel()
    eu = float(np.sqrt(np.mean((u_c - GHIA_U[100]) ** 2)))
    ev = float(np.sqrt(np.mean((v_c - GHIA_V[100]) ** 2)))
    say("fem_ghia_gate", n=32, steps=FEM_GHIA_STEPS, eu=eu, ev=ev, tol=FEM_GHIA_TOL,
        poisson_res=float(m.poisson_res[-1]))
    if not (eu < FEM_GHIA_TOL and ev < FEM_GHIA_TOL and float(m.poisson_res[-1]) < 1e-4):
        raise AssertionError(f"FEM Ghia: {eu}, {ev}")
    # (e) the implicit adjoint on the card: the gradient of the Poiseuille
    # loss of tests/test_fem.py:280 against the same on the CPU
    grads = {dev: _fem_gradient(dev) for dev in ("cuda", "cpu")}
    rel = float(np.abs(grads["cuda"] - grads["cpu"]).max() / np.abs(grads["cpu"]).max())
    say("fem_gradient", max_abs_grad=float(np.abs(grads["cpu"]).max()), rel_cuda_cpu=rel,
        tol=FEM_GRAD_RTOL)
    if not rel <= FEM_GRAD_RTOL:
        raise AssertionError(f"FEM gradient on the card {rel} from the CPU's")
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel ran on the FEM tier: {launches}")


def _fem_gradient(device) -> np.ndarray:
    """d mean(u²)/d u0 after one monolithic step of the Poiseuille channel
    (tests/test_fem.py:280), through the implicit adjoint."""
    from cfdsim_tpu_torch.fem.assembly import build_element_ops
    from cfdsim_tpu_torch.fem.mesh import rectangle_mesh
    from cfdsim_tpu_torch.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu_torch.models import fem as mfem

    spaces = build_spaces(rectangle_mesh(12, 6, (0.0, 4.0), (0.0, 1.0)), "p1p1")
    g = dirichlet_values(spaces, {"inlet": lambda x, y: (4.0 * y * (1.0 - y), 0 * y),
                                  "walls": lambda x, y: (0 * x, 0 * y)})
    ops = build_element_ops(spaces, device=device)
    cfg = mfem.FEMConfig(nu=0.1, dt=0.1, space="p1p1", gmres_tol=1e-6, gmres_restart=120,
                         gmres_maxiter=10)
    state = mfem.solve_stokes(ops, cfg, g)
    u0 = state.u.clone().requires_grad_()
    new, _ = mfem.make_step(ops, cfg, g)(state._replace(u=u0), 1.0)
    torch.mean(new.u ** 2).backward()
    return u0.grad.cpu().numpy()


def _cavity_gradient(device):
    """d mean(u_8²)/d u0 through 8 steps of lid_cavity(n=24, Re=100, jacobi
    8) on the chunk's loop route (tests/test_differentiability.py:20-38)."""
    case = lid_cavity(n=24, Re=100.0, poisson=PoissonConfig(method="jacobi", iters=8),
                      device=device)
    chunk = make_chunk(case.cfg, case.step, GRAD_STEPS, route="loop")
    u0 = case.state.u.clone().requires_grad_()
    state, _ = chunk(case.state._replace(u=u0), 1.0)
    torch.mean(state.u ** 2).backward()
    return u0.grad.cpu().numpy(), chunk


def _sharded_mac_gradient(mesh):
    """d mean(u_4²)/d u0 of the 16² MAC cavity (rbsor 20 sweeps, fixed dt,
    metrics off) through the distributed step on ``mesh`` and through the
    single-device step (tests/test_differentiability.py:58-92)."""
    from cfdsim_tpu_torch.parallel import (
        gather_blocks,
        make_cavity_mac_explicit_step,
        shard_trimmed_state,
        trim_state,
    )

    def case():
        return lid_cavity_mac(n=16, Re=100.0, poisson=PoissonConfig(method="rbsor", iters=20),
                              adaptive_dt=False, dt_base=1e-3, compute_metrics=False,
                              device=mesh.device)

    c = case()
    step = make_cavity_mac_explicit_step(c.cfg, mesh)
    t0 = shard_trimmed_state(trim_state(c.state), mesh)
    u0 = t0.u.clone().requires_grad_()
    s = t0._replace(u=u0)
    for _ in range(4):
        s, _ = step(s, 1.0)
    (torch.sum(s.u ** 2) / (16 * 16)).backward()
    g_dist = gather_blocks(u0.grad, mesh)
    c = case()
    u1 = c.state.u[:, :-1].clone().requires_grad_()
    s = c.state._replace(u=torch.nn.functional.pad(u1, (0, 1)))
    for _ in range(4):
        s, _ = c.step(s, 1.0)
    torch.mean(s.u[:, :-1] ** 2).backward()
    return g_dist.cpu().numpy(), u1.grad.cpu().numpy()


def phase_gradients(card):
    """Gradients through the time loop on the card: the 8-step cavity on the
    loop route against the CPU's; the graph route refusing a state, and the
    adjoint example's step whose forcing, that requires grad (before any
    capture); the fused predictor's wrapper
    refusing one (the kernel has no backward); the adjoint example at its
    default size (n = 48, 200 steps) for ``ADJOINT_ITERS`` Adam iterations.
    No kernel runs."""
    _reset_counts()
    (g_card, chunk), (g_cpu, _) = _cavity_gradient("cuda"), _cavity_gradient("cpu")
    rel = float(np.abs(g_card - g_cpu).max() / np.abs(g_cpu).max())
    say("gradient_cavity", n=24, steps=GRAD_STEPS, route=chunk.mode, reason=chunk.reason,
        max_abs_grad=float(np.abs(g_cpu).max()), rel_cuda_cpu=rel, tol=GRAD_CARD_RTOL)
    if not (chunk.mode == "loop" and np.abs(g_cpu).max() > 0 and rel <= GRAD_CARD_RTOL):
        raise AssertionError(f"cavity gradient on the card {rel} from the CPU's")

    case = lid_cavity(n=24, Re=100.0, poisson=PoissonConfig(method="jacobi", iters=8),
                      device="cuda")
    graph = make_chunk(case.cfg, case.step, GRAD_STEPS)
    state = case.state._replace(u=case.state.u.clone().requires_grad_())
    try:
        graph(state, 1.0)
        refused = None
    except ValueError as e:
        refused = str(e)
    say("gradient_graph_route_refused", route=graph.mode, refused=refused,
        captured=graph.program is not None)
    if graph.mode != "graph" or refused is None or graph.program is not None:
        raise AssertionError(f"the graph route took a state that requires grad: {refused}")
    # the adjoint example's step carries the control in its forcing buffer,
    # from a state at rest
    step = adjoint_forcing.make_problem(48, 1, device="cuda").step(
        torch.zeros(4, device="cuda", requires_grad=True))
    graph = make_chunk(step.cfg, step, GRAD_STEPS)
    try:
        graph(mac.init_state(step.cfg, device="cuda"), 1.0)
        refused = None
    except ValueError as e:
        refused = str(e)
    say("gradient_graph_route_refused_forcing", route=graph.mode, refused=refused,
        captured=graph.program is not None)
    if graph.mode != "graph" or refused is None or graph.program is not None:
        raise AssertionError(f"the graph route took a step whose forcing requires grad: "
                             f"{refused}")

    case = lid_cavity(n=1024, Re=1000.0, fused_predictor=True, device="cuda")
    state = case.state._replace(u=case.state.u.clone().requires_grad_())
    try:
        case.step(state, 1.0)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    say("gradient_kernel_refused", n=1024, refused=refused)
    if refused is None or "no backward" not in refused:
        raise AssertionError("the fused predictor's wrapper took a tensor that requires grad")
    del case, state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    err = adjoint_forcing.main(iters=ADJOINT_ITERS, verbose=False, device="cuda")
    seconds = time.perf_counter() - t0
    say("adjoint_forcing", n=48, steps=200, iterations=ADJOINT_ITERS, lr=0.1, max_err=err,
        gate=ADJOINT_ERR, seconds=seconds, ms_per_iteration=seconds / ADJOINT_ITERS * 1e3,
        card=card)
    if not err < ADJOINT_ERR:
        raise AssertionError(f"the adjoint example recovered c within {err}")
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel ran on the gradient path: {launches}")


def _within(label, got, want, rtol, atol, **fields):
    """max |got − want| − (atol + rtol·|want|) ≤ 0, numpy.testing's rule."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - (atol + rtol * want.abs())).max())
    say(label, max_abs_err=err, rtol=rtol, atol=atol, bit_equal=bool(torch.equal(got, want)),
        **fields)
    if excess > 0:
        raise AssertionError(f"{label}: max |Δ| {err} over rtol {rtol}, atol {atol}")


def _profile_pair(path, cfg, dist_step, dist_state, single, card, steps=10):
    """ms and device events per step of the distributed step (its loop) and
    of the single-device step (its loop and its captured chunk)."""
    from types import SimpleNamespace

    rows = [profile_chunk(SimpleNamespace(cfg=cfg, step=dist_step, state=dist_state), steps,
                          "cuda", card, "loop", path=path, side="distributed_world1")]
    for route in ("loop", None):
        rows.append(profile_chunk(single, steps, "cuda", card, route, path=path,
                                  side="single_device"))
    for row in rows:
        row.pop("top_self_device_us")
        say("distributed_profile", **row)


def phase_distributed(card):
    """The distributed steps on one card: a NCCL group of world size 1 (the
    card's machine has one GPU, and NCCL puts no two ranks on one GPU; the
    exchanges between ranks are checked on gloo on the CPU by the tests).
    Each step is held against the single-device step at the JAX tests'
    tolerances, and timed beside it; then the sharded MAC gradient."""
    from cfdsim_tpu_torch.parallel import (
        block_state,
        gather_state,
        init_distributed,
        make_cavity_explicit_step,
        make_cavity_mac_explicit_step,
        make_heated_cavity_explicit_step,
        shard_boussinesq_state,
        shard_trimmed_state,
        trim_boussinesq_state,
        trim_state,
    )

    rendezvous = SMOKE_OUT / "nccl_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    mesh = init_distributed("nccl", f"file://{rendezvous}", 1, 0, device="cuda:0")
    try:
        _reset_counts()
        say("distributed_mesh", backend=mesh.backend, py=mesh.py, px=mesh.px,
            device=str(mesh.device))
        # the collocated cavity, the JAX package's PoissonConfig defaults (rbsor)
        case = lid_cavity(n=1024, Re=1000.0, poisson=PoissonConfig(), device="cuda")
        step = make_cavity_explicit_step(case.cfg, mesh)
        d, r = block_state(case.state, mesh), case.state
        for _ in range(DIST_STEPS):
            d, _ = step(d, 1.0)
            r, _ = case.step(r, 1.0)
        g = gather_state(d, mesh)
        _within("distributed_cavity_uv", torch.stack([g.u, g.v]), torch.stack([r.u, r.v]),
                1e-5, 1e-6, n=1024, steps=DIST_STEPS, poisson="rbsor:100")
        _within("distributed_cavity_p", g.p, r.p, 1e-4, 1e-5, n=1024, steps=DIST_STEPS)
        # 5,000 device events a step: two steps keep the profiler's pass short
        _profile_pair("cavity1024_rbsor", case.cfg, step, d, case, card, steps=2)
        del case, step, d, r, g
        # the MAC cavity with the pencil DCT
        case = lid_cavity_mac(n=1024, Re=1000.0, device="cuda")
        step = make_cavity_mac_explicit_step(case.cfg, mesh)
        d, r = shard_trimmed_state(trim_state(case.state), mesh), case.state
        for _ in range(DIST_STEPS):
            d, _ = step(d, 1.0)
            r, _ = case.step(r, 1.0)
        g = gather_state(d, mesh)
        _within("distributed_mac_uv", torch.stack([g.u, g.v]),
                torch.stack([r.u[:, :-1], r.v[:-1, :]]), 0.0, 2e-5, n=1024, steps=DIST_STEPS)
        _within("distributed_mac_p", g.p, r.p, 0.0, 2e-4, n=1024, steps=DIST_STEPS)
        _profile_pair("cavity_mac1024_dct", case.cfg, step, d, case, card)
        del case, step, d, r, g
        # the heated cavity at heated_cavity()'s defaults
        case = heated_cavity(device="cuda")
        step = make_heated_cavity_explicit_step(case.cfg, mesh)
        d = shard_boussinesq_state(trim_boussinesq_state(case.state), mesh)
        r = case.state
        for _ in range(BQ_DIST_STEPS):
            d, md = step(d, 1.0)
            r, mr = case.step(r, 1.0)
        g = gather_state(d, mesh)
        _within("distributed_heated_cavity", torch.stack([g.u, g.v, g.theta]),
                torch.stack([r.u[:, :-1], r.v[:-1, :], r.theta]), 0.0, 3e-5,
                n=case.grid.nx, Ra=case.cfg.rayleigh, steps=BQ_DIST_STEPS)
        _within("distributed_heated_cavity_nu", md.nu_hot_wall.reshape(1),
                mr.nu_hot_wall.reshape(1), 1e-4, 0.0)
        _profile_pair(f"heated_cavity{case.grid.nx}", case.cfg, step, d, case, card)
        del case, step, d, r, g
        # the sharded MAC gradient against the single-device gradient
        g_dist, g_single = _sharded_mac_gradient(mesh)
        rel = float(np.abs(g_dist - g_single).max() / np.abs(g_single).max())
        say("distributed_mac_gradient", n=16, steps=4, max_abs_grad=float(np.abs(g_single).max()),
            rel_distributed_single=rel, tol=1e-5)
        if not (np.abs(g_single).max() > 0 and rel <= 1e-5):
            raise AssertionError(f"sharded MAC gradient {rel} from the single-device one")
        launches = _counts()
        if any(launches.values()):
            raise AssertionError(f"a kernel ran on the distributed steps: {launches}")
    except BaseException:
        torch.distributed.destroy_process_group()
        raise
    return mesh


class _Bound:
    """A distributed step with its call-time blocks (masks) bound, for a
    chunk: ``bound(state, cfl_scale)``; it keeps the step's route facts."""

    def __init__(self, step, extras):
        self.step, self.extras = step, tuple(extras)
        self.device, self.reads_host, self.collectives = step.device, False, True

    def __call__(self, state, cfl_scale):
        return self.step(state, cfl_scale, *self.extras)


def _trimmed(state):
    """The trimmed faces (2D or 3D) of a full state, as the distributed steps
    hold them."""
    if state.u.ndim == 2:
        return state._replace(u=state.u[:, :-1], v=state.v[:-1, :])
    return state._replace(u=state.u[:, :, :-1], v=state.v[:, :-1, :], w=state.w[:-1])


def _dist_pair(label, case, step, mesh, card, steps, atol, extras=(), metric_tols=None,
               **fields):
    """``steps`` of the distributed ``step`` (its blocks cut from the full
    state) against the case's single-device step from the same state: the
    trimmed faces (θ too) within ``atol`` and each metric in
    ``metric_tols`` within its (rtol, atol) (the JAX tests'); p's largest
    |Δ| is printed beside max|p| (the tier-1 twins hold it at the JAX tests'
    sizes: here the projection divides the predictor's rounding by dt, and
    the faces bound ∇φ's error by atol/dt); then both profiled."""
    from cfdsim_tpu_torch.parallel import block_state, gather_state, local_block

    blocks = tuple(local_block(x, mesh) for x in extras)
    d, r = block_state(_trimmed(case.state), mesh), case.state
    t0 = time.perf_counter()
    for _ in range(steps):
        d, md = step(d, 1.0, *blocks)
        r, mr = case.step(r, 1.0)
    torch.cuda.synchronize()
    g, ref = gather_state(d, mesh), _trimmed(r)
    names = [k for k in ("u", "v", "w", "theta") if hasattr(ref, k)]
    _within(f"distributed_{label}", torch.cat([getattr(g, k).reshape(-1) for k in names]),
            torch.cat([getattr(ref, k).reshape(-1) for k in names]), 0.0, atol, fields=names,
            steps=steps, seconds=time.perf_counter() - t0, **fields)
    say(f"distributed_{label}_p", max_abs_err=float((g.p - ref.p).abs().max()),
        max_abs_p=float(ref.p.abs().max()))
    for k, (rtol, atol_m) in (metric_tols or {}).items():
        _within(f"distributed_{label}_{k}", getattr(md, k).reshape(1),
                getattr(mr, k).reshape(1), rtol, atol_m)
    _profile_pair(label, case.cfg, _Bound(step, blocks), d, case, card,
                  steps=DIST_SLICE_PROFILE)


def phase_distributed_slices(card, mesh):
    """The 2D staggered and 3D distributed steps (items 22b and 22c) on the
    NCCL group of world size 1 that ``phase_distributed`` opened, at full
    width: each held against its single-device step at the JAX tests'
    tolerances and profiled beside it; no kernel launched."""
    from cfdsim_tpu_torch.parallel import (
        make_cavity3d_mac_explicit_step,
        make_cylinder_stretched_explicit_step,
        make_heated_cube_explicit_step,
        make_heated_sphere_stretched_explicit_step,
        make_moving_body_mac_explicit_step,
        make_sphere_ghost3d_stretched_explicit_step,
        make_sphere_mac3d_explicit_step,
        trim_face_masks,
        trim_face_masks3d,
    )

    _reset_counts()
    steps = DIST_SLICE_STEPS
    # the 256³ lid-driven cavity through the 3D DCT (BASELINE.json config 5)
    case = build("cavity3d_mac", n=256, device="cuda")
    _dist_pair("cavity3d_mac256", case, make_cavity3d_mac_explicit_step(case.cfg, mesh), mesh,
               card, 3, 2e-5, n=256)
    del case
    # sphere() at 192×96×96 (TVD, penalization masks)
    case = build("sphere", device="cuda")
    _dist_pair("sphere192x96x96", case,
               make_sphere_mac3d_explicit_step(case.cfg, mesh, v_inf=1.0, ibm_ramp_steps=200),
               mesh, card, steps, 2e-5, trim_face_masks3d(*case.extras["ibm_masks"]),
               {"fx": (1e-4, 1e-6)})
    del case
    # the Re = 3900 stretched ghost sphere with dynamic LES (bench.sphere_paths'
    # configuration on the central scheme, the distributed stretched tier's
    # one, and without its inlet perturbation, which the distributed
    # external-flow BCs do not take)
    case = build("sphere_stretched", Re=3900.0, scheme="central", ibm_scheme="ghost",
                 use_les=True, les_model="dynamic", device="cuda")
    ex = case.extras
    _dist_pair("sphere_stretched192x96x96_ghost_dynamic_les", case,
               make_sphere_ghost3d_stretched_explicit_step(
                   case.cfg, mesh, ex["x_faces"], ex["y_faces"], ex["z_faces"], ex["ibm_ghost"],
                   v_inf=1.0, ibm_ramp_steps=200), mesh, card, steps, 5e-5,
               metric_tols={"fx": (3e-4, 1e-6)})
    del case, ex
    # the stretched heated sphere (its defaults on the central scheme)
    case = build("heated_sphere_stretched", scheme="central", device="cuda")
    ex = case.extras
    mu, mv, mw, mc = ex["ibm_masks"]
    _dist_pair("heated_sphere_stretched192x96x96", case,
               make_heated_sphere_stretched_explicit_step(
                   case.cfg, mesh, ex["x_faces"], ex["y_faces"], ex["z_faces"], v_inf=1.0,
                   ibm_ramp_steps=200), mesh, card, steps, 2e-5,
               extras=(*trim_face_masks3d(mu, mv, mw), np.asarray(mc, np.float32)),
               metric_tols={"nusselt": (2e-4, 0.0)})
    del case, ex
    # the heated cube at its defaults (48³)
    case = build("heated_cube", device="cuda")
    _dist_pair("heated_cube48", case, make_heated_cube_explicit_step(case.cfg, mesh), mesh,
               card, DIST_SLICE_STEPS_CUBE, 5e-5,
               metric_tols={"nu_hot_wall": (1e-4, 0.0), "nu_mid": (1e-3, 1e-4)})
    del case
    # 2D: the oscillating cylinder (480×240) with the moving ghost, and the
    # stretched cylinder (512×256)
    case = build("cylinder_oscillating", ibm_scheme="ghost", device="cuda")
    _dist_pair("cylinder_oscillating480x240_ghost", case, make_moving_body_mac_explicit_step(
        case.cfg, mesh, case.extras["body"], moving_scheme="ghost"), mesh, card, steps, 2e-5,
        metric_tols={"fx": (2e-4, 1e-6), "fy": (2e-4, 1e-6)})
    del case
    case = build("cylinder_stretched", device="cuda")
    ex = case.extras
    _dist_pair("cylinder_stretched512x256", case, make_cylinder_stretched_explicit_step(
        case.cfg, mesh, ex["x_faces"], ex["y_faces"], v_inf=1.0, perturb_ramp_steps=200,
        ibm_ramp_steps=200), mesh, card, steps, 2e-5,
        trim_face_masks(ex["ibm_mask_u"], ex["ibm_mask_v"]),
        {"fx": (1e-4, 1e-6), "fy": (1e-4, 1e-6)})
    del case, ex
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel ran on the distributed steps: {launches}")


def _timed_steps(step, state, steps):
    """``steps`` calls of ``step`` from ``state``: (state, last metrics, wall
    ms of each step, each ended by a synchronisation)."""
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, 1.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, m, ms


def phase_distributed_tiers(card, mesh):
    """The pseudo-spectral and FEM distributed steps (item 22d) on the NCCL
    group of world size 1 that ``phase_distributed`` opened, at full width:
    the pencil-FFT step at 1024² against ``PSStep`` (real-space ω and the
    metrics), the element-sharded monolithic and projection steps on the
    bench's FEM cylinder against ``FEMStep``/``FEMProjectionStep`` (u, p,
    fx; their Krylov counts printed beside the single-device ones, which may
    differ by rounding); each step's wall ms beside the single-device
    step's; no kernel launched."""
    from cfdsim_tpu_torch.parallel import (
        block_state,
        full_spectrum_state,
        gather_state,
        make_fem_explicit_step,
        make_fem_projection_explicit_step,
        make_ps_explicit_step,
    )

    _reset_counts()
    case = build("kolmogorov_ps", ny=1024, noise=0.1, device="cuda")
    cfg = case.cfg
    d, md, d_ms = _timed_steps(make_ps_explicit_step(cfg, mesh),
                               block_state(full_spectrum_state(cfg, case.state), mesh),
                               DIST_TIER_PS_STEPS)
    r, mr, r_ms = _timed_steps(case.step, case.state, DIST_TIER_PS_STEPS)
    w_dist = torch.fft.ifft2(gather_state(d, mesh).w_hat).real
    w_ref = torch.fft.irfft2(r.w_hat, s=(cfg.ny, cfg.nx))
    _within("distributed_ps1024_w", w_dist, w_ref, 0.0,
            PS_DIST_W_RTOL * float(w_ref.abs().max()), n=cfg.ny, steps=DIST_TIER_PS_STEPS,
            ms_per_step=d_ms, single_device_ms_per_step=r_ms, card=card)
    for k in ("energy", "enstrophy", "max_vel"):
        _within(f"distributed_ps1024_{k}", getattr(md, k).reshape(1),
                getattr(mr, k).reshape(1), PS_DIST_METRIC_RTOL, 0.0)
    del case, d, r, w_dist, w_ref

    for path, case in fem_paths("cuda").items():
        ops, g = case.extras["ops"], case.extras["g"]
        force = case.extras["spaces"].dirichlet_tag_nodes["cylinder"]
        if path.endswith("projection"):
            step = make_fem_projection_explicit_step(ops, case.cfg, g,
                                                     case.extras["mesh"].tags["outlet"], mesh,
                                                     force_nodes=force)
        else:
            step = make_fem_explicit_step(ops, case.cfg, g, mesh, force_nodes=force)
        case.step.counts.clear()
        d, md, d_ms = _timed_steps(step, case.state, DIST_TIER_FEM_STEPS)
        r, mr, r_ms = _timed_steps(case.step, case.state, DIST_TIER_FEM_STEPS)
        _within(f"distributed_{path}_u", d.u, r.u, 0.0,
                FEM_DIST_U_RTOL * float(r.u.abs().max()), n_tris=case.extras["mesh"].n_tris,
                steps=DIST_TIER_FEM_STEPS, ms_per_step=d_ms, single_device_ms_per_step=r_ms,
                krylov=dict(step.counts), krylov_single_device=dict(case.step.counts),
                card=card)
        _within(f"distributed_{path}_p", d.p, r.p, 0.0, FEM_DIST_P_ATOL)
        _within(f"distributed_{path}_fx", md.fx.reshape(1), mr.fx.reshape(1), 0.0,
                FEM_DIST_FX_ATOL)
        del case, step, d, r
    torch.cuda.empty_cache()
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel ran on the distributed steps: {launches}")


def phase_drivers(card):
    """Three example drivers on the card, as a user runs them: the
    reference-parity cylinder (``cylinder_reference_v5 --ref-parity --io
    native``, one 200-step chunk: healthy, its ``.csnap`` read back, kernel
    A's cluster kernel launched once per step and once per warm-up step, as
    it counts on the device), the wedge (``wedge_shock`` to a short t, its
    θ-β-M report) and the staggered tiers at world size 1
    (``sharded_mac_tiers --device cuda --ranks 1``, its own NCCL rank)."""
    from cfdsim_tpu_torch.examples import cylinder_reference_v5, sharded_mac_tiers, wedge_shock

    out = SMOKE_OUT / "drivers"
    shutil.rmtree(out, ignore_errors=True)
    _reset_counts()
    t0 = time.perf_counter()
    v5 = cylinder_reference_v5.run(cylinder_reference_v5.parse_args(
        ["--ref-parity", "--io", "native", "--max-steps", str(DRIVER_V5_STEPS),
         "--out", str(out / "cylinder_v5")]))
    launches = _counts()
    wall = time.perf_counter() - t0
    report, sim = v5["report"], v5["sim"]
    _healthy("cylinder_reference_v5", v5["state"], report, DRIVER_V5_STEPS, 5.0)
    steps = csnap_steps(v5["snapshots"])
    fields, t_last = steps[max(steps)]
    say("driver_cylinder_reference_v5", steps=sorted(steps), launches=launches,
        final_time=report["final_time"], snapshot_time=t_last, wall_s=wall,
        **_chunk_facts(sim), card=card)
    want = {"predictor": 0, "rbsor_a": DRIVER_V5_STEPS + sim.chunk.steps_per_graph,
            "rbsor_a_cooperative": 0, "rbsor_b": 0}
    if (launches != want or sorted(steps) != [0, DRIVER_V5_STEPS]
            or set(fields) != {"u", "v", "p"} or fields["u"].shape != (180, 600)
            or not all(np.isfinite(a).all() for a in fields.values())):
        raise AssertionError(f"cylinder_reference_v5: launches {launches} (want {want}), "
                             f"snapshot steps {sorted(steps)}, fields {sorted(fields)}")

    t0 = time.perf_counter()
    rc = wedge_shock.main(["--t-final", str(DRIVER_WEDGE_T), "--io", "native",
                           "--out", str(out / "wedge")])
    wedge = json.loads((out / "wedge" / "report.json").read_text())
    say("driver_wedge_shock", t_final=DRIVER_WEDGE_T, rc=rc, wall_s=time.perf_counter() - t0,
        beta_deg=wedge["beta_deg"], p2_p1=wedge["p2_p1"], rho2_rho1=wedge["rho2_rho1"],
        steps=wedge["run_report"]["final_step"], snapshots=sorted(csnap_steps(
            out / "wedge" / "snapshots.csnap")))
    if rc != 0 or not all(math.isfinite(wedge[k]) for k in ("beta_deg", "p2_p1", "rho2_rho1")):
        raise AssertionError(f"wedge_shock: rc {rc}, report {wedge}")

    t0 = time.perf_counter()
    tiers = sharded_mac_tiers.main(["--device", "cuda", "--ranks", "1", "--steps",
                                    str(DRIVER_MAC_TIER_STEPS), "--out", str(out / "mac_tiers")])
    say("driver_sharded_mac_tiers", wall_s=time.perf_counter() - t0, **tiers)
    rows = {r["tier"]: r for r in tiers["rows"]}
    if (tiers["backend"] != "nccl" or set(rows) != set(DRIVER_MAC_TIER_ATOL)
            or any(rows[k]["max_abs_err"] > atol for k, atol in DRIVER_MAC_TIER_ATOL.items())):
        raise AssertionError(f"sharded_mac_tiers: {tiers}")
    return launches["rbsor_a"]


def _study_driver(card, name, run, steps_of, check):
    """Run one study driver as a user does (``run()``: its ``main`` with
    ``--device cuda --io native``), with every kernel's count zeroed just
    before and read just after: none may launch. ``steps_of(result)`` is
    the steps it ran, ``check(result)`` raises on a report that is not
    right (not finite, a snapshot or npz that does not read back)."""
    _reset_counts()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    steps = steps_of(result)
    facts = check(result)
    say("study_driver", name=name, steps=steps, wall_s=wall, steps_per_s=steps / wall,
        launches=launches, **facts, card=card)
    if any(launches.values()):
        raise AssertionError(f"{name} launched kernels: {launches}")
    return wall


def _finite(name, values, **facts) -> dict:
    """Raises unless every array or number in ``values`` is finite; returns
    ``facts`` (scalars for the phase's line)."""
    bad = [k for k, v in values.items() if not np.isfinite(np.asarray(v, np.float64)).all()]
    if bad:
        raise AssertionError(f"{name}: not finite: {bad}")
    return facts


def _csnap_fields(path, name, step, outside_nan=False):
    """The fields' shapes at ``step`` in the ``.csnap`` at ``path``: the step
    there, every field finite (with ``outside_nan``, where it is not NaN by
    design, outside an FEM mesh: some point finite)."""
    steps = csnap_steps(path)
    if step not in steps:
        raise AssertionError(f"{name}: {path} holds steps {sorted(steps)}, not {step}")
    fields, _ = steps[step]
    for k, a in fields.items():
        inside = a[~np.isnan(a)] if outside_nan else a
        if not (inside.size and np.isfinite(inside).all()):
            raise AssertionError(f"{name}: {k} of {path} is not finite")
    return {k: list(a.shape) for k, a in fields.items()}


def phase_study_drivers(card):
    """The eight study drivers on the card, each through its ``main`` at its
    published grid for one or two short chunks (``STUDY_DRIVERS``): its
    report finite, its ``.csnap`` (or npz) read back, no kernel launched;
    the Re = 3900 sphere's ``--save``/``--resume`` and the 1024² accuracy
    run's npz resume each continue one chunk from their checkpoint; the FEM
    cylinder counts its accepted steps, and on a coarse mesh must advance."""
    from cfdsim_tpu_torch.examples import (
        cavity_accuracy_1024,
        cavity_rossiter,
        cylinder_fem,
        kolmogorov_spectrum,
        schafer_turek_2d2,
        sphere_les_re3900,
        sphere_wake,
        tgv3d_les,
    )
    from cfdsim_tpu_torch.models import fem as mfem

    out = SMOKE_OUT / "study_drivers"
    shutil.rmtree(out, ignore_errors=True)
    common = ["--device", "cuda", "--io", "native"]
    walls = {}

    def args(name, *extra):
        return [*extra, *common, "--out", str(out / name)]

    n = STUDY_SPHERE_STEPS
    walls["sphere_wake"] = _study_driver(
        card, "sphere_wake",
        lambda: sphere_wake.main(args("sphere_wake", "--n", "12", "--chunk-steps", str(n),
                                      "--max-steps", str(n))),
        lambda r: len(r["fx"]),
        lambda r: _finite("sphere_wake", {k: r[k] for k in ("cd", "l_r_d", "fx")}, cd=r["cd"],
                          l_r_d=r["l_r_d"],
                          fields=_csnap_fields(out / "sphere_wake" / "snapshots.csnap",
                                               "sphere_wake", n)))
    n = STUDY_TGV_STEPS
    walls["tgv3d_les"] = _study_driver(
        card, "tgv3d_les",
        lambda: tgv3d_les.main(args("tgv3d_les", "--n", "64", "--chunk", str(n), "--max-steps",
                                    str(n))),
        lambda r: len(r["dt"]),
        lambda r: _finite("tgv3d_les", {k: r[k] for k in ("E", "eps_peak", "slope")},
                          E_last=float(r["E"][-1]), eps_peak=r["eps_peak"], slope=r["slope"],
                          fields=_csnap_fields(out / "tgv3d_les" / "snapshots.csnap",
                                               "tgv3d_les", n)))
    n = STUDY_RE3900_CHUNK
    save = out / "re3900_series.npz"
    re3900 = ["--chunk-steps", str(n), "--tail", "0", "--save", str(save), "--ckpt-every", "1"]

    def re3900_check(r, steps):
        series = np.load(save)
        if len(series["t"]) != steps or len(r["t"]) != steps:
            raise AssertionError(f"sphere_les_re3900: {len(series['t'])} series rows, want "
                                 f"{steps}")
        return _finite("sphere_les_re3900", {k: r[k] for k in ("cd_mean", "cd", "probe_v")},
                       cd_mean=r["cd_mean"], st=r["st"], st_wake=r["st_wake"],
                       fields=_csnap_fields(out / "sphere_les_re3900" / "snapshots.csnap",
                                            "sphere_les_re3900", steps))

    walls["sphere_les_re3900"] = _study_driver(
        card, "sphere_les_re3900",
        lambda: sphere_les_re3900.main(args("sphere_les_re3900", *re3900, "--max-steps",
                                            str(2 * n))),
        lambda r: len(r["t"]), lambda r: re3900_check(r, 2 * n))
    walls["sphere_les_re3900_resume"] = _study_driver(
        card, "sphere_les_re3900_resume",
        lambda: sphere_les_re3900.main(args("sphere_les_re3900", *re3900, "--resume",
                                            "--max-steps", str(3 * n))),
        lambda r: n, lambda r: re3900_check(r, 3 * n))
    for solver, extra in STUDY_KOLMOGOROV.items():
        name = f"kolmogorov_spectrum_{solver}"
        walls[name] = _study_driver(
            card, name,
            lambda: kolmogorov_spectrum.main(args(name, "--n", "256", "--solver", solver,
                                                  *extra)),
            lambda r: len(r["energy"]),
            lambda r: _finite(name, {k: r[k] for k in ("E_k", "energy")}, k_peak=r["k_peak"],
                              slope_inverse=r["slope_inverse"], slope_direct=r["slope_direct"],
                              fields=_csnap_fields(out / name / "snapshots.csnap", name,
                                                   len(r["energy"]))))
    n = STUDY_ROSSITER_STEPS
    walls["cavity_rossiter"] = _study_driver(
        card, "cavity_rossiter",
        lambda: cavity_rossiter.main(args("cavity_rossiter", "--chunk-steps", str(n),
                                          "--max-steps", str(n), "--tail", "0")),
        lambda r: len(r["t"]),
        lambda r: _finite("cavity_rossiter", {k: r[k] for k in ("t", "p", "psd")},
                          min_rho=float(np.min(r["min_rho"])), peaks=r["peaks"],
                          fields=_csnap_fields(out / "cavity_rossiter" / "snapshots.csnap",
                                               "cavity_rossiter", n)))
    n = STUDY_ACCURACY_CHUNK
    first, second = out / "cavity_acc_1024.npz", out / "cavity_acc_1024_resumed.npz"

    def accuracy_check(r, steps, npz):
        d = np.load(npz)
        if int(d["step"]) != steps or d["u"].shape != (STUDY_ACCURACY_N, STUDY_ACCURACY_N + 1):
            raise AssertionError(f"cavity_accuracy_1024: {npz} at step {int(d['step'])}")
        return _finite("cavity_accuracy_1024", {"errors": list(r["errors"].values()),
                                                "u": d["u"]},
                       max_err=r["max_err"], t=r["t"],
                       fields=_csnap_fields(out / "cavity_accuracy_1024" / "snapshots.csnap",
                                            "cavity_accuracy_1024", steps))

    walls["cavity_accuracy_1024"] = _study_driver(
        card, "cavity_accuracy_1024",
        lambda: cavity_accuracy_1024.main(args("cavity_accuracy_1024", str(STUDY_ACCURACY_N),
                                               "1e9", str(first), "incremental", "--chunk-steps",
                                               str(n), "--max-steps", str(n))),
        lambda r: r["step"], lambda r: accuracy_check(r, n, first))
    walls["cavity_accuracy_1024_resume"] = _study_driver(
        card, "cavity_accuracy_1024_resume",
        lambda: cavity_accuracy_1024.main(args("cavity_accuracy_1024", str(STUDY_ACCURACY_N),
                                               "1e9", str(second), "incremental", str(first),
                                               "--chunk-steps", str(n), "--max-steps",
                                               str(2 * n))),
        lambda r: n, lambda r: accuracy_check(r, 2 * n, second))
    accept = mfem.FEMConfig().accept_relres  # the cylinder case keeps the default

    def fem_check(name, r, steps, must_advance):
        """A step whose solve ends above ``accept_relres`` keeps its state:
        the line counts the accepted steps and says whether the flow moved;
        ``must_advance`` runs fail unless every step was accepted and the
        drag changed."""
        row = r["Re_100"]
        res = np.asarray(row["poisson_res"])
        accepted = int((res < accept).sum())
        advanced = accepted > 0 and float(np.max(row["fx"]) - np.min(row["fx"])) > 0
        if must_advance and not (accepted == steps and advanced):
            raise AssertionError(f"{name}: {accepted} of {steps} steps accepted (relres {res}), "
                                 f"fx {row['fx']}")
        return _finite(name, {k: row[k] for k in ("fx", "fy", "Cd", "poisson_res")},
                       Cd=row["Cd"], relres_max=float(res.max()), accept_relres=accept,
                       accepted_steps=accepted, flow_advanced=advanced,
                       fields=_csnap_fields(out / name / "Re_100" / "snapshots.csnap", name,
                                            steps, outside_nan=True))

    # the case's mesh: every monolithic GMRES there ends above accept_relres,
    # in the JAX driver too (ROADMAP queue 3), so its line reports the steps
    # as rejected; the coarse mesh's steps converge and must move the flow
    for name, n, mesh, must_advance in (
            ("cylinder_fem", STUDY_FEM_CYLINDER_STEPS, [], False),
            ("cylinder_fem_coarse", STUDY_FEM_COARSE_STEPS,
             ["--h-near", "0.3", "--h-far", "1.5"], True)):
        walls[name] = _study_driver(
            card, name,
            lambda: cylinder_fem.main(args(name, "100", "--t-final", str(n * 0.05),
                                           "--chunk-steps", str(n), *mesh)),
            lambda r: r["Re_100"]["steps"],
            lambda r: fem_check(name, r, n, must_advance))
    n = STUDY_SCHAFER_TUREK_STEPS
    walls["schafer_turek_2d2"] = _study_driver(
        card, "schafer_turek_2d2",
        lambda: schafer_turek_2d2.main(args("schafer_turek_2d2", "--t", str(n * 0.002),
                                            "--chunk-steps", str(n))),
        lambda r: len(r["cd_series"]),
        lambda r: _finite("schafer_turek_2d2", {k: r[k] for k in ("cd", "cd_series",
                                                                    "cl_series")},
                          n_tris=r["n_tris"], cd=r["cd"],
                          fields=_csnap_fields(out / "schafer_turek_2d2" / "snapshots.csnap",
                                               "schafer_turek_2d2", n, outside_nan=True)))
    torch.cuda.empty_cache()
    return walls


def phase_timings(card):
    # main path, in turns on the same card: fused, unfused, unfused, fused,
    # each through the captured chunk and then through the eager loop
    for fused in (True, False, False, True):
        for route in (None, "loop"):
            r = run_bench(n=1024, fused_predictor=fused, route=route)
            say("time_main_path", fused_predictor=fused, route=r["route"],
                cells_per_s=r["value"], ms_per_step=r["ms_per_step"],
                t_short_s=r["t_short_s"], t_long_s=r["t_long_s"], nodes=r.get("nodes"),
                steps_per_graph=r.get("steps_per_graph"), capture_s=r.get("capture_s"),
                card=card)
    # the device time of one main-path step (no host dispatch in it)
    step_ms = {fused: step_device_ms(1024, fused) for fused in (True, False)}
    say("time_step_device", n=1024, fused_ms=step_ms[True], unfused_ms=step_ms[False],
        fused_cells_per_s=1024 * 1024 / (step_ms[True] * 1e-3),
        unfused_cells_per_s=1024 * 1024 / (step_ms[False] * 1e-3), card=card)
    # device events, busy time and idle share per step, metrics off: the
    # three paths through the captured chunk and through the eager loop
    for route in (None, "loop"):
        for path, case in {**_paths(compute_metrics=False), **new_paths(),
                           **mac_paths(), **boussinesq_paths()}.items():
            say("time_profile", **profile_chunk(case, PROFILE_STEPS, "cuda", card, route,
                                                path=path))
        for path, case in {**threed_paths(), **sphere_paths()}.items():
            say("time_profile", **profile_chunk(case, PROFILE_STEPS_3D, "cuda", card, route,
                                                path=path))
        torch.cuda.empty_cache()
        for path, case in {**compressible_paths(), **spectral_paths()}.items():
            say("time_profile", **profile_chunk(
                case, PROFILE_STEPS_3D if "3d" in path else PROFILE_STEPS, "cuda", card, route,
                path=path))
        torch.cuda.empty_cache()
    # per tier the flops and bytes of one step against the card's peaks
    for row in run_roofline(1024):
        say("time_roofline", **row)
    # the predictor alone at the main path's shape and at 4096², inputs
    # streamed from device memory: plain, kernel, kernel, plain; then a
    # plain copy of the same bytes and an empty launch
    pred_t = predictor_ms(1024, reps=200)
    say("time_predictor", shape=[1024, 1024], **pred_t, card=card)
    pred_4096 = predictor_ms(4096, reps=50)
    say("time_predictor", shape=[4096, 4096], **pred_4096, card=card)
    # kernel A: one 50-sweep chunk of the cylinder's masked solve (a
    # cluster of 16), then 50 sweeps on each other route: a cluster of 1
    # and of 8, and the cooperative kernel on the cylinder at twice its
    # resolution
    a_t = rbsor_ms((180, 600), sweeps=50, reps=20)
    say("time_rbsor_a", **a_t, card=card)
    a_paths = {f"cluster{a_t['cluster']}": a_t}
    for shape, masked in [((32, 48), False), ((128, 256), False), ((360, 1200), True)]:
        t = rbsor_ms(shape, sweeps=50, reps=10, masked=masked)
        say("time_rbsor_a", **t, card=card)
        a_paths[t["route"] if t["route"] == "cooperative" else f"cluster{t['cluster']}"] = t
    # the multigrid's largest kernel-A level, 512², 2 sweeps: the route the
    # plan takes (cooperative) against the cluster route the size alone gives
    for plan in (None, rb.plan_rbsor((512, 512), rb.max_cluster("cuda"))):
        t = rbsor_ms((512, 512), sweeps=2, reps=20, masked=False, plan=plan)
        say("time_rbsor_a", **t, card=card)
        a_paths[f"mg512_{t['route'] if plan is None else 'forced_cluster'}"] = t
    # the cluster route's synchronisation per half-sweep, at minimal work
    sync_us = {c: rbsor_sync_us(c) for c in (1, 8, 16)}
    say("time_rbsor_a_sync", us_per_half_sweep=sync_us, card=card)
    # kernel B: the multigrid fine level's 2-sweep call, 1, 4 and 8 sweeps
    # (8: one full pass) at 1024² (TMA loads), whose intercept is the cost
    # of the pass without its sweeps, and 2 sweeps at 1000×1030 (cp.async),
    # inputs streamed from device memory
    b_t = {k: rbsor_blocked_ms((1024, 1024), sweeps=k, reps=50) for k in (1, 2, 4, 8)}
    b_cp = rbsor_blocked_ms((1000, 1030), sweeps=2, reps=50)
    for t in (*b_t.values(), b_cp):
        say("time_rbsor_b", **t, card=card)
    # the JAX bench's secondary metrics, and the cylinder through kernel A
    # and through streaming rbsor
    for row in run_all(1024, steps=SECONDARY_STEPS, steps_3d=SECONDARY_STEPS_3D):
        say("time_secondary", **row)
    for row in run_cylinder():
        say("time_cylinder", **row)

    def best(t):
        return min(t["kernel_device_ms"])

    n = 1024 * 1024
    sweeps = a_t["sweeps"]
    kernels = {
        "fused_predictor_central": dict(
            ms=best(pred_t), plain_ms=min(pred_t["plain_device_ms"]),
            bound=_bound_ms(4 * 4 * n, PREDICTOR_FLOPS_PER_CELL * n),
            plan=pred_t["route"], copy_ms=min(pred_t["copy_device_ms"]),
            empty_launch_ms=min(pred_t["empty_device_ms"]),
            paths_ms={"4096x4096": {
                "ms": best(pred_4096), "plan": pred_4096["route"],
                "copy_ms": min(pred_4096["copy_device_ms"]),
                "bound_ms": _bound_ms(4 * 4 * 4096 * 4096,
                                      PREDICTOR_FLOPS_PER_CELL * 4096 * 4096)[0]}}),
        "rbsor": dict(
            ms=best(a_t), plain_ms=min(a_t["plain_device_ms"]),
            # φ, rhs, mask in; φ out; every fluid cell updated per sweep
            bound=_bound_ms(4 * 4 * 180 * 600,
                            RBSOR_FLOPS_PER_UPDATE * a_t["fluid_cells"] * sweeps),
            paths_ms={k: {"ms": best(t), "shape": t["shape"], "masked": t["masked"],
                          "sweeps": t["sweeps"]} for k, t in a_paths.items()},
            sync_us_per_half_sweep={f"cluster{c}": us for c, us in sync_us.items()}),
        "rbsor_blocked": dict(
            ms=best(b_t[2]), plain_ms=min(b_t[2]["plain_device_ms"]),
            # φ, rhs in; φ out; every cell updated per sweep
            bound=_bound_ms(3 * 4 * n, RBSOR_FLOPS_PER_UPDATE * n * 2),
            paths_ms={f"{t['route']}_{t['shape'][0]}x{t['shape'][1]}_k{t['sweeps']}":
                      best(t) for t in (*b_t.values(), b_cp)}),
    }
    return kernels


def _timed_phases():
    """``phase(fn, *args)`` runs one phase and prints its seconds; the
    seconds of every phase so far are on ``phase.seconds``."""
    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase.seconds[fn.__name__] = time.perf_counter() - t0
        say("phase_seconds", name=fn.__name__, seconds=phase.seconds[fn.__name__])
        return out

    phase.seconds = {}
    return phase


def main() -> int:
    t_start = time.perf_counter()
    card = card_name_and_power_limit()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    has = machine_has()
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], count=torch.cuda.device_count(), machine_has=has)
    needs = ("g++", "zlib.h") if SNAPSHOT_IO == "native" else ("h5py",)
    if not all(has[k] for k in needs):
        raise RuntimeError(f"the {SNAPSHOT_IO} snapshot writer needs {needs}: {has}")

    kernels = (pred.KERNEL, *rb.KERNELS)
    say("build", seconds_per_source=cuda_build.build_all(kernels, [EMPTY_SOURCE]),
        kernels=[k.symbol for k in kernels])
    err = {"fused_predictor_central": phase_kernel_vs_plain()}
    err["rbsor"], err["rbsor_blocked"] = phase_rbsor_vs_plain()
    phase = _timed_phases()
    phase(phase_chunk_routes)
    phase(phase_golden)
    dct_table = phase(phase_dct_variants, card)
    phase(phase_fdm_precision)
    phase(phase_mac_paths)
    mac_mg, mac_cyl = phase(phase_mac_kernels)
    phase(phase_mac_goldens)
    phase(phase_botella_peyret)
    bq_mg = phase(phase_boussinesq)
    phase(phase_3d)
    phase(phase_3d_bodies, card)
    phase(phase_compressible, card)
    phase(phase_spectral, card)
    phase(phase_new_tiers_resume)
    phase(phase_fem, card)
    phase(phase_gradients, card)
    mesh = phase(phase_distributed, card)
    try:
        phase(phase_distributed_slices, card, mesh)
        phase(phase_distributed_tiers, card, mesh)
    finally:
        torch.distributed.destroy_process_group()
    v5_a = phase(phase_drivers, card)
    phase(phase_study_drivers, card)
    pred_launches = phase(phase_main_path)
    cyl_a, cyl_chunks_per_step = phase(phase_cylinder)
    mg = phase(phase_mg_cavity)
    implicit_mg = phase(phase_implicit_cavity)
    phase(phase_ghia)
    les_a = phase(phase_les_cylinder)
    transport_pred = phase(phase_transport_resume)
    times = phase(phase_timings, card)

    launches = {
        "fused_predictor_central": {"cavity_1024_dct": pred_launches,
                                    "transport_1024_split_run": transport_pred},
        "rbsor": {"cylinder_600x180": cyl_a, "cavity_1024_mg": mg["rbsor_a"],
                  "cavity_1024_mg_cooperative": mg["rbsor_a_cooperative"],
                  "cylinder_600x180_les": les_a,
                  "cylinder_reference_v5_600x180": v5_a,
                  "cavity_1024_implicit_mg": implicit_mg["rbsor_a"],
                  "cavity_1024_implicit_mg_cooperative": implicit_mg["rbsor_a_cooperative"],
                  "cavity_mac_1024_mg": mac_mg["rbsor_a"],
                  "cavity_mac_1024_mg_cooperative": mac_mg["rbsor_a_cooperative"],
                  "cylinder_mac_720x240": mac_cyl["rbsor_a"],
                  "heated_cavity_1024_mg": bq_mg["rbsor_a"],
                  "heated_cavity_1024_mg_cooperative": bq_mg["rbsor_a_cooperative"]},
        "rbsor_blocked": {"cavity_1024_mg": mg["rbsor_b"],
                          "cavity_1024_implicit_mg": implicit_mg["rbsor_b"],
                          "cavity_mac_1024_mg": mac_mg["rbsor_b"],
                          "heated_cavity_1024_mg": bq_mg["rbsor_b"]},
    }
    info = {
        "fused_predictor_central": ("cfdsim_tpu_torch/csrc/predictor.cu",
                                    "cfdsim_tpu/ops/pallas/predictor.py:77",
                                    "1024² cavity, inputs from device memory"),
        "rbsor": ("cfdsim_tpu_torch/csrc/rbsor.cu", "cfdsim_tpu/ops/pallas/poisson_rb.py:237",
                  "one 50-sweep masked chunk at 180×600"),
        "rbsor_blocked": ("cfdsim_tpu_torch/csrc/rbsor.cu",
                          "cfdsim_tpu/ops/pallas/poisson_rb.py:155",
                          "one 2-sweep call at 1024², inputs from device memory"),
    }
    rows = []
    for name, (source, replaces, timed) in info.items():
        t = times[name]
        bound_ms, bound_by = t["bound"]
        for x in (err[name], t["ms"], t["plain_ms"], bound_ms):
            if not math.isfinite(x):
                raise AssertionError(f"non-finite measurement for {name}")
        if not sum(launches[name].values()):
            raise AssertionError(f"{name} was not launched on its path")
        extra = {k: v for k, v in t.items() if k not in ("ms", "plain_ms", "bound")}
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "timed": timed,
            **extra,
        })
    rows[1]["kernel_chunks_per_cylinder_step"] = cyl_chunks_per_step
    say("dct_autotune_table", winners={n: t["winner"] for n, t in dct_table.items()},
        ms=dct_table, card=card)
    say("smoke_seconds", seconds=time.perf_counter() - t_start, phase_seconds=phase.seconds)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
