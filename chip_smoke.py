#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's main path (adjoint_ode_adaptivity_tpu_torch) phase by
phase and prints what each phase found on its own line. Any failing phase
raises, and the script exits non-zero; nothing is caught.

0. The card's name and power limit (nvidia-smi); exit 1 without a CUDA
   device. TF32 is switched off and checked.
1. Build the CUDA kernels from csrc/ with nvcc (cached by source hash).
2. Each kernel against its plain PyTorch version on the same inputs, float32:
   (a) graded mesh N=2, K=24, B=8; (b) N=7, K=24, B=8; (c) K=10^4, N=2, B=8;
   after phase 3, (d) the last graded mesh of the adaptive study at B=1.
3. The main path through its entry point, ``drivers.advec_dg.main(["--adapt",
   "--kernel", "cuda", ...])``, with the kernels' launch counts; the same study
   with ``--kernel torch`` (float32 eager on the card); each mesh of the CUDA
   study replayed through the eager engine; the refinement decisions of both
   engines on a configuration whose indicator lies above float32 roundoff;
   one ``--estimate --kernel cuda`` run; and the driver's plain march
   (``--kernel cuda --k 512``, K1 at B=1) with its launch count.
4. The headline pipeline (K=10^4, N=2, 2048 steps, B=8, stored trajectory),
   timed with CUDA events for the kernels and for their plain versions; and
   K1 at the plain march's shape against its plain version, timed likewise.
5. The float64 effectivity identity Ση = J(u_dt) − J(u_dt/2) on the
   headline mesh and step (B=1), on bench.py's effectivity problem
   (u0 = sin(800x), J over [π, π+1], 64 steps), through the plain path, to
   1e-10 relative.
6. Each FD kernel (csrc/fd_ensemble.cu) against its plain version, float32:
   (a) sin(u) at 102,400 ICs, 16 steps, rf 4, trig libm and fast; (b) a
   graded dt vector; (c) gaussian_mixture, and the other scalar ODEs at
   4,096 ICs; (d) the d=2 harmonic oscillator at 102,400 ICs; (e) the
   per-member kernel at B=1024, 43 steps, padded tails, both conventions.
7. The FD paths through their entry points: ``drivers.fd_adaptive.main(
   ["--ensemble", "1024", "--engine", "cuda", "--device-loop", "--tol", "0",
   "--maxit", "40"])`` with the per-member kernel's launch count, every
   iteration's grid replayed through the plain version and the torch
   engine; the ensemble refinement signal through make_cuda_fd_ensemble(_vec);
   and the single-run fd_adaptive default.
8. CUDA-event times of each FD kernel and its plain version at the phase-6
   shapes, and of the B=1024 study with each engine.
9. The DG slab kernel D1 (csrc/dg_slab.cu, G lanes a member) against its
   plain version, float32, each output within its per-member, per-element
   bound (ops/cuda/dg_slab.dg_kernel_tolerance) through the wrapper and on
   every (G, CTA size) that d1_plan chooses from, a repeat bit-identical,
   and in every case some |err| above its bound (an err of 0 fails): (a)
   order 1 at bench.py's shapes (B=16,384, K=16, t in [0, 2], y0 ~ U(0.5, 2)
   seed 1, 5 Newton steps), libm and fast trig; (b) order 2 (Cramer) on
   K=2 slabs and order 4 (elimination) on du/dt=10cos(u), K=4, at B=1024,
   where err lies above float32 roundoff; (c) per-member partitions with
   zero-width tails, whose contributions are exactly 0; (d) t*sin(u) (K=16)
   and gaussian_mixture (K=4) at 4,096 members; (e) B=102,400, seed 3.
10. The DG-in-time paths through their entry points: ``drivers.dg_adaptive.
   main(["--ensemble", "1024", "--per-member", "--device-loop"])`` with the
   kernel's launch count, every iteration's partitions replayed through the
   plain version (float32, held to the per-element err bound) and the torch
   engine (float64), the decisions compared where the top-two margin clears
   4x the member's largest err bound (some must); ``--ensemble 1024`` on
   the shared partition; and the single-run default ``dg_adaptive --maxit
   30`` in float64 on the card against ``--device cpu``.
11. CUDA-event times of the DG slab kernel and its plain version at 9(a)
   (libm and fast), 9(e) and 9(c), the wrapper (d1_plan's G) in turns
   against one lane a member; and of the B=1024 ensemble and per-member
   studies (bench.py's k0 4, maxit 10, tol 0, 8 Newton steps) with each
   engine, the per-member study also in turns on d1_plan's launch and on
   one lane a member.
12. The hp kernel (csrc/dg_slab_mixed.cu) against its plain version,
   float32, in both adjoint modes: (a) bench.py's hp shape (B=512, seed 5,
   per-member partitions over K=15 slabs with zero-width tails, orders 1..3,
   stack np_max 6, 8 Newton steps); (b) B=4096, seed 6; (c) np_max 8 at
   B=1024; (d) t*sin(u) and gaussian_mixture at B=4096; (e) uniform orders
   1..3 against the DG slab kernel on the same Gauss rule. Tails contribute
   exactly 0. u_c, u_f, v and err are each held to their per-element bound
   (ops/cuda/dg_slab_mixed.hp_kernel_tolerance).
13. The hp paths through their entry points: the main path ``drivers.
   dg_adaptive.main(["--hp", "hp", "--ensemble", "512", "--seed", "5",
   "--per-member", "--device-loop", ...])`` (bench.py's hp study) with the
   kernel's launch count, every iteration replayed through the plain
   version (float32) and the torch engine (float64), decisions compared
   where the top-two margin clears the float32 bound; the same with
   ``--adjoint reconstruct``; the shared-partition ensemble signal; and the
   float64 single run ``--hp p --k0 4 --n-max 4 --tol 1e-9`` on the card
   against ``--device cpu``.
14. CUDA-event times of the hp kernel and its plain version at 12(a) and
   12(b) in each adjoint mode, and of the B=512 and B=4096 per-member hp
   studies with each engine; a torch.profiler trace of one B=512 study (the
   device's busy share, the kernel's share of it, the host's launches,
   synchronisations and copies).

15. The fused training kernel T1 (csrc/train_fused.cu) against its plain
   version in float64, each gradient entry held to its own float32 bound:
   (a) bench.py's shape (S=10, F=500, B=8192, dt 0.1, ICs ~ U(0.5, 2) seed 11,
   targets sin u at t=1); (b) masked at capacity 500 with n_active varying
   per step, inactive gradients exactly 0; (c) the mixed loss with full
   trajectory targets and a ramp weight; (d) 0/1 member weights; (e) zero-dt
   padded steps, exact identities with gradients exactly 0; (f) S=48. Every
   case twice: bit-identical.
16. The fused Dense-chain kernel T2 (csrc/train_dense_fused.cu) against its
   plain version likewise at (100, 500), B=8192 (seed 13), S=10 and S=100
   (bench.py:1183-1200), and with zero-dt steps.
17. The NN path through its entry point: ``drivers.train_resnet_ode.main(
   ["--method", "variable_params", "--width", "500", "--n-train", "8192",
   "--epochs", "50", "--maxit", "3"])`` with T1's launch count, its first
   outer iteration replayed through ``--train-engine torch`` on the card and
   the insertion decision compared where its margin clears the tolerance;
   ``--method recurrent --hidden 100,500 --n-train 8192`` with T2's launch
   count; ``width``, ``new_loss`` and ``detect`` at n-train 1024 (every T1
   variant through the driver).
18. CUDA-event times of T1 and T2 and of their plain versions at 15(a) and
   16, and of T2 at its path's minibatch (B=512, 2 steps); epochs/s of a
   full train step (kernel + Adam) with each engine; the same hidden-chain
   GEMMs through torch.matmul in IEEE FP32 as T2's yardstick.
19. The Burgers kernel B1 (csrc/burgers.cu) against its plain version:
   (a) bench.py's row (K=10^4, N=2, B=8, dt = 0.3·x_min, 2048 steps, ICs
   (0.5 + 0.05 j)·sin x, ΠN) in float64 to 1e-12·|plain| + 1e-13, and in
   float32 per entry to 8·n_steps·ε₃₂·max|u0|, with ΠN's final-state masks
   compared; (b) B=1 through make_cuda_burgers_march_single; (c) a graded
   mesh N=4, K=48, B=8, all three limiters, both types.
20. The Burgers path through its entry points: the main path ``drivers.
   burgers_dg.main(["--kernel", "cuda"])`` (K=48, N=4, T=1.5, 7,500 steps
   across the shock) with B1's launch count and the post-shock properties
   (finite, within the initial range up to 5e-2, Σ cell averages·h
   conserved to float32 roundoff); ``--kernel torch`` in float64 on the
   card (run on a thread beside phase 1's build, which leaves the card
   idle), and B1 in float64 against it; ``advec_dg --limiter n`` and ``1``
   on the card against ``--device cpu``.
21. Revolve: ``revolve_advec_estimate`` at K=10^4, 2048 steps, unit 128,
   4 snaps against the stored pipeline, with K1/K2's launch counts; at
   bench.py's row (K=10^5, 16,384 steps, unit 128, 16 snaps) timed against
   the stored pipeline (CUDA events, median of 5); at 81,920 steps, where
   the stored pipeline raises MemoryError (98.3 GB), with its peak memory.
22. CUDA-event times of B1 at 19(a) and at B=1 (median of 5), beside its
   bound and its plain version's one run.
23. The recompute pipeline (csrc/dg_rhs.cu: K1's checkpoint mode, K2r) and
   the pure adjoint march KA: (a) each against its plain version on a graded
   mesh and at N=7, and K2r against K2 bit for bit; (b) the main path, the
   advec_dg adaptive study with no free memory reported, so that the loop
   takes the recompute pipeline, with the kernels' launch counts and the
   stored study's history bit for bit; (c) bench.py's batched row (K=10^4,
   N=2, B=8, 2048 steps, segment 4) recompute against stored in the same
   call, bit-equal, both timed in turns, each kernel and its plain version
   timed;
   (d) make_cuda_advec_adjoint (KA) at B=1 against its plain version, with
   its launch count, and the two unbatched estimates against the stored
   single pipeline.
24. The element-tiled pipeline (KT1 and KT2: K1's and K2's fused kernels at
   B = 1 from the global step offset, csrc/dg_rhs.cu fwd_fused and
   rev_fused): (a) against its plain version
   (the tile plan's tiles and ghost windows) at K=640, and KT2 bit-equal to
   the stored pipeline's K2 on the same trajectory through its wrapper, on
   narrow fused tiles, and one segment a call from the global step offset
   with η carried in; (b) bench.py's rows (K=10^5, segment 8, chunks 4, 256
   steps; K=10^6, segment 16, chunks 25, 64 steps) through both tiled
   factories, bit-equal to the stored pipeline, timed in turns with it, the
   main path's launch count from the K=10^6 tiled_grid run; (c) KT1 and KT2
   alone at K=10^6 (KT2 on its stored_plan windows) against K1's and K2's
   plain versions, timed.
25. The unbatched recompute pipeline at phase 21(c)'s row past memory
   (K=10^5, 81,920 steps, segment 256): time, peak device memory, and u,
   λ0 and η against revolve's from 21(c).
26. The MXU-layout pipeline (csrc/dg_mxu.cu: KM1, KM2) at Np 2, 3 and 8
   (tests/test_pallas_mxu.py's steps, B=8): against its plain version (the
   same float32 operations in the same order), and against the stored K1/K2
   pipeline on the same inputs at tests/test_pallas_mxu.py's tolerances.
27. KM1+KM2 against K1+K2 timed in turns at BASELINE.md:61's row (N=7,
   K=10^4, B=8, segment 2, 256 steps; the main path's launch count, each KM
   kernel and its plain version timed) and at the headline row (N=2, 2048
   steps), with the ratio KM/K1K2 on its own line.
28. The element-sharded pipelines (ops/cuda/dg_sharded.py over KT1/KT2, a
   call each a segment) at
   phase 24(b)'s K=10^6 row (segment 16, 64 steps): both factories at world
   1 in this process and at world 2 in two spawned ranks (gloo, both on
   cuda:0), u_final, λ0 and η bit-equal to the single-process tiled
   pipeline, J within its summation bound of Σλu, times beside the tiled
   pipeline's; parallel/dg_shard.py's pipeline at world 2 in float64
   (K=10^4, N=2, 64 steps) against the single-device estimate at 1e-10.

29. K2 and K2r fused over s_f steps a launch (csrc/dg_rhs.cu): (a) K2 at
   the headline on the wrappers' SM-balanced plan and four widest-window
   plans (s_f 4 and 8, 512- and 1024-thread CTAs) in turns, bit-equal, with
   CUDA launches a call, the plans' cost model and the share of the bound;
   (b) K2r at bench.py's batched row with segments 4 and 64, K2's bits; (c)
   phase 24's rows at B=1: K1 + K2 against KT1 + KT2 and K2 against KT2 in
   turns, bit-equal, and (a)'s plans there; (d) (a)'s plans at K=512, B=1,
   2048 steps; the registers and spills that ptxas reported for the fused
   kernels.
30. K1 fused over s_f steps a launch (csrc/dg_rhs.cu fwd_fused) at the four
   rows it serves: (a) the trajectory at the headline; (b) the checkpoints
   at bench.py's batched row, segments 4 and 64; (c) revolve's advance (K=10^5,
   B=1, one 128-step unit from t0 = 0.5, no store); (d) the advec_dg march
   (K=512, B=1, 5,462 steps, no store). At each, the wrappers' plan beside
   four widest-window plans (s_f 8, 16 and 32 on 512- and 1024-thread CTAs)
   and the wrapper itself, timed in turns, each with the plans' cost model,
   its CUDA launches and its share of K1's bound; every plan's stored states
   and u_final the wrapper's bits (a gate); and the registers and spills
   that ptxas reported for fwd_fused.
31. KA fused over s_f steps a launch (csrc/dg_rhs.cu adj_fused) at phase
   23(d)'s row (K=10^4, N=2, B=1, 2048 steps): the wrapper and its plan
   beside four widest-window plans (s_f 8, 16 and 32 on 512- and 1024-thread
   CTAs), timed in turns, each with the plans' cost model, its CUDA launches
   and its share of KA's bound, every plan λ0 the wrapper's bits (a gate);
   the registers and spills that ptxas reported for adj_fused.
32. T2 on its thread-block cluster (csrc/train_dense_fused.cu) at its
   path's minibatch (B=512, S=2) and at bench.py's (B=8192, S=10): the
   wrapper's (BM, C) plan beside every other plan the kernel takes, timed
   in turns, each within dense_kernel_tolerance at its own (BM, C) (a gate);
   the same hidden-chain GEMMs through torch.matmul in IEEE FP32; the share
   of t2_bound; a torch.profiler trace of 20 wrapper calls; the registers
   and spills of the kernel.
33. B1 fused over s_f steps a launch (csrc/burgers.cu burgers_fused) and T1
   split over neurons within a member tile (csrc/train_fused.cu): the
   registers and spills that ptxas reported for both; (a) B1 at
   burgers_dg's shape (K=48, N=4, B=1, 7,500 steps, ΠN: one ring CTA) and
   at bench.py's row (K=10^4, N=2, 2048 steps) at B=8 and B=1: the
   wrapper and its plan beside the widest plans (s_f 2-16 on 512- and
   1024-thread CTAs) and the ring where a CTA holds the mesh, timed in
   turns, each with the plans' cost model, its CUDA launches and its share
   of B1's bound, every plan's output the wrapper's bits (a gate; in
   float64 the wrapper is held to the untiled plain version in phase 19);
   (b) T1 at F=500, B=8192 and S=2, 5 and 10 (the variable_params path's
   depths and bench.py's): the wrapper beside every member tile the kernel
   takes (8-64 members), timed in turns, each within
   resblock_kernel_tolerance at its own tile's reduction (a gate), with its
   share of t1_bound; (c) 20 back-to-back T1 calls at S=2 on the host clock,
   on the device alone (queued behind a sleep, CUDA events) and under
   torch.profiler: the device's busy share of the calls' wall, the host's
   side, each launch's device time.
34. KM2 fused over s_f steps a launch (csrc/dg_mxu.cu km_rev_fused) and H1
   with G lanes a member (csrc/dg_slab_mixed.cu): the registers and spills
   that ptxas reported for both (no km_rev_fused instance may spill); (a)
   KM2 at phase 26's meshes (B=8, 13 steps) on every plan km_rev_plan
   searches and on narrow tiles, bit-equal to km_adj_est_plain; (b) at both
   MXU_ROWS the wrapper beside each (s_f, CTA size) at its cheapest tiling,
   timed in turns, each with its CUDA
   launches, the cost model and the KM_STEP_WARP_US it implies, and its
   share of the bound, every plan the wrapper's bits and the wrapper the
   plain version's (a gate); (c) is 36(c); (d) H1 at 12(a) and 12(b) (B=512 and 4096) in both adjoint modes
   on G = 1, 4, 8, 16, 32 lanes and 64-, 128- and 256-thread CTAs, timed in
   turns beside the wrapper, each within hp_kernel_tolerance and
   bit-identical on a repeat (a gate), with its share of the bound; (e)
   phase 14's B=512 hp study in turns on hp_plan's launch and on one lane a
   member, and its torch.profiler trace.
35. KT2 on K2's fused windows and D1 with G lanes a member: the registers
   and spills that ptxas reported for rev_fused and dg_estimate_kernel; (a)
   KT2 at phase 24's K=10^6 row on the wrapper's plan and, for each (s_f,
   CTA size) stored_plan searches, the tiling its cost model rates cheapest,
   timed in turns, each with its CUDA launches, the cost model and its share
   of the bound, the whole sweep and the sweep one 16-step segment a call
   (the sharded composition's calls: the global step offset, η carried in)
   both the stored pipeline's bits (a gate); (b) D1 at B=1024 (9(c), the
   studies' shape), 16,384 (9(a)) and 102,400 (9(e)) on every G and CTA
   size, timed in turns beside the wrapper, each within dg_kernel_tolerance
   (a gate), with its share of the bound.
36. KM1 fused over s_f steps a launch (csrc/dg_mxu.cu km_fwd_fused) and F3
   with G lanes a member (csrc/fd_ensemble.cu): (a) the registers and
   spills that ptxas reported for both (no km_fwd_fused instance may
   spill: a gate); (b) KM1 at KM2_SMALL's shapes (B=8, 13 steps) on every
   plan km_fwd_plan searches and on narrow tiles, and at both MXU_ROWS on
   the wrapper's plan and each (s_f, CTA size)'s cheapest tiling, timed in
   turns with its CUDA launches, the cost model, the KM_FWD_STEP_WARP_US it
   implies and its share of the bound; every plan's trajectory and u_final
   the wrapper's bits and the wrapper's km_fwd_traj_plain's (a gate); (c)
   KM1+KM2 against K1+K2 at both rows in turns; (d) F3 at 6(e)'s shape on
   every G and CTA size, timed in turns beside the wrapper and G = 1, each
   within fd_kernel_tolerance with some plain entry above it, padding
   exactly 0, a repeat bit-identical and the wrapper's bits (a gate), and
   G = 1, G = 32 and the wrapper on the device alone (queued behind a
   sleep); (e) the B=1024 per-member FD
   study (phase 8's) in turns on fd_pm_plan's launch and on one lane a
   member, and its torch.profiler trace.
37. KT1 as a call of K1's fused march (csrc/dg_rhs.cu fwd_fused at B = 1
   from the global step offset) and F1 with G lanes an IC
   (csrc/fd_ensemble.cu fd_ensemble_kernel): (a) the registers and spills
   that ptxas reported for both (no instance may spill: a gate); (b) KT1 at
   both TILED_ROWS on the wrapper's plan and each (s_f, CTA size)'s
   cheapest tiling, timed in turns with its CUDA launches, the cost model,
   the FWD_STEP_WARP_US it implies and its share of the bound, every plan's
   trajectory and u_final, whole and one segment a call, the stored
   pipeline's K1 bits (a gate), and tiled/stored in turns; (c) F1 and
   F1-fast at FD_ENSEMBLE's shape, and F1 at 4,096 ICs, on every G and CTA
   size, timed in turns beside the wrapper and G = 1, each within
   fd_kernel_tolerance with some
   plain entry above it and a repeat bit-identical (a gate), on the device
   alone (queued behind a sleep) beside the call, and the ensemble signal's
   argmax against the float64 plain version's where the top-two margin
   clears twice the tolerance.
38. The goal J = ∫u² (g_u = 2u by a functor of csrc/odes.cuh) on D1 and H1,
   and T2's bf16 tensor-core mode: the SASS of both dense_cluster_kernel
   instances (HMMA in the bf16 one only: a gate) and their registers; (a)
   D1 with the goal at the per-member study's shape (B=1024, K=15) and
   bench.py's (B=16,384, K=16) on every G and CTA size, each within the
   extended dg_kernel_tolerance (a gate), some plain |err| above its bound
   and the J = ∫u kernel's v outside it (the bound bites), the J = ∫u
   kernel's bits against the parent's digest (PARENT_DIGESTS), and the two
   goals timed in turns; (b) H1 likewise at B=512 (both adjoint modes) and
   B=4096; (c) phase 10's per-member DG study (B=1024) and phase 13's hp
   study (B=512) through run_adaptive_dg_per_member and
   run_adaptive_dg_hp_per_member with g = u², g_u = 2u on the kernels, every
   iteration replayed through the plain version and the float64 torch
   engine, with the kernels' launch counts; (d) T2 bf16 at (100, 500), B=8192
   S=10 and S=100 and the recurrent path's B=512 S=2 within the bf16 bound
   of the float64 bf16 plain version (every (BM, C) at B=512), the
   float32 mode outside that bound, the float32 mode's bits over every plan
   against the parent's digest, timed in turns beside the float32 wrapper
   and torch.matmul's bf16 GEMMs (a yardstick), with the share of
   t2_bf16_bound; (e) five steps of make_shared_train_step_fused(...,
   mxu_dtype=torch.bfloat16): the loss falls and stays finite.
41. The IFT-differentiable DG marches, the config facade and the host tools,
   float64: (a) dg_march_differentiable (N=2, 16 slabs, f = sin(p·u)),
   its values dg_march's to 1e-12, d/d(y0, p, times) the CPU's to 1e-10
   relative and central differences' to 1e-6; (b) a width-32 tanh MLP
   right-hand side trained through dg_march_batched_differentiable (B =
   16,384, 16 slabs, N = 1 and 2, 8 Newton steps, five train.Adam steps
   toward the sin(u) flow's u(T)): the loss falls; one forward + backward
   timed (CUDA events) with the backward's share, a torch.profiler trace
   (launches, busy share); the same five steps over the first 256 members
   on the card and on the CPU (in a process of its own, beside the rest of
   the phase), every step's loss and gradients to 1e-10 relative, and
   those members' u(T) in the full march the 256-member march's to 1e-12;
   (c)
   dg_march_mixed_differentiable on orders 1-4 over 16 elements, its values
   dg_march_mixed's to 1e-12 and its gradients the CPU's; (d) every Funs
   field of get_problem_functions on the card against device="cpu" (sin(u),
   J = ∫u², 10^4 steps) to 1e-12; (e) ops/io round-trips a K = 10^4
   Discretization1D bit for bit, profiling.trace around one stored-pipeline
   estimate (launches recorded against launches run), and sweep runs two
   fd_adaptive seeds on the card at --parallel 2, both rc 0 (beside (a),
   (c)-(e); (b) runs after it).
42. A caller's elementwise callables traced into device functors
   (ops/cuda/functor.py) on F1, F2, F3, D1 and H1: (a) the user libraries
   (one csrc file and the generated header each) built together, each its
   seconds and its instances' registers; (b) F1 on u(1−u) + 0.1·cos(2t) with
   its hand-written f_u and F2 on Van der Pol (tests/test_pallas.py:564-573)
   at 102,400 ICs, F3 at the per-member study's shape (B = 1024, 43 steps),
   each within fd_kernel_tolerance of its plain version with some plain
   entry above the bound, timed in turns beside the registry kernel at the
   same shape, and the registry F1-F3 bits against the parent's digests;
   (c) D1 with f_u derived on Dual<float> and g_u = 1/u at B = 1024 (K =
   15) and 16,384 (K = 16) on per-member partitions within
   dg_kernel_tolerance (bounds that bite, tails exactly 0), timed beside
   the registry kernel (sin u, J = ∫u²), and sin(u) spelled as a callable
   within the registry functor's bounds of its output; (d) H1 likewise at
   B = 512, finite through the padding's zero nodes; (e) each through the
   entry points a user calls, its launch count from 0: the F1 and F2
   signals, the B = 1024 per-member FD study on ``ode_f``, the B = 1024
   per-member DG study (device loop, ``ode=None``, f and g_u = 1/u; its
   last partitions replayed to the history's err bits) and the B = 512 hp
   study; (f) an untraceable callable (a reduction) refused on every path
   with no launch.
43. High order, Np 9-16 (N = 8-15), on csrc/dg_rhs.cu's and
   csrc/burgers.cu's kernels (one thread an element, as at Np 2-8): (a) the
   registers and spills of every instance at Np 9-16; (b) at Np 9, 12 and
   16 on the headline mesh (K = 10^4, B = 8, 64 steps, phased sines with
   nodal noise) K1, K2, K2r and KA against their plain versions within
   tolerances() (Np/8 above Np = 8) with teeth, K2r K2's bits, and B1 in
   float64 and float32 step by step; on the smooth phased sines at the
   headline step, where η lies below float32 roundoff, K2's η within 4x
   the float32 plain run's distance from the float64 one, a bfloat16
   trajectory outside it; (c) the kernels at Np 2-8 against the parent's
   digests (tools/torch_dg_digests.py); (d) the headline pipeline (2048
   steps, stored trajectory) and B1 at N = 8 and 11, timed, with DoF-steps/s,
   CUDA launches and the share of the bound; (e) the paths at N = 8:
   advec_dg --adapt --kernel cuda --order 8 against --kernel torch (replayed
   to the noise bound), the recompute pipeline's bits, both engines'
   decisions on sin(20x), the march alone, make_cuda_advec_adjoint,
   burgers_dg --kernel cuda --order 8, a tiled and a revolve call.
44. F2 on traced vector ODEs of 5-15 components at 102,400 ICs (Lorenz-96,
   F = 8, at d = 5 over 16 steps and d = 8 over 8, rf 4, dt 0.0125; a dense
   d = 15 system at 1 step, rf 16): (a) the user libraries built together,
   each case's instance's registers and spills, the kernel against its
   plain version within fd_kernel_tolerance(…, d) with teeth and a bfloat16
   run of the plain version outside it, device and call ms, the plain ms
   and the bound, and Lorenz-96 on the window design beside the register
   design; (b) each case through make_cuda_fd_ensemble_vec, its launch
   count from 0; (c) the registry F2 and the traced d = 2, 3 and 4 against
   the parent's digests.

The line before the last is a JSON object with each kernel's launches on
its path, error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "adjoint_ode_adaptivity_tpu_torch"
A = 6.283185307179586  # 2π
HEADLINE = dict(n_order=2, k=10_000, n_steps=2048, batch=8)
EFFECTIVITY_STEPS = 64  # bench.py:410's effectivity run on the headline mesh
SOURCES = {
    "fwd_march": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_est_stored": f"{PACKAGE}/csrc/dg_rhs.cu",
    "fd_ensemble": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_ensemble_vec": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_estimate_per_member": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "dg_estimate_ensemble": f"{PACKAGE}/csrc/dg_slab.cu",
    "dg_estimate_hp_per_member": f"{PACKAGE}/csrc/dg_slab_mixed.cu",
    "resblock_epoch_grad": f"{PACKAGE}/csrc/train_fused.cu",
    "dense_epoch_grad": f"{PACKAGE}/csrc/train_dense_fused.cu",
    "burgers_march": f"{PACKAGE}/csrc/burgers.cu",
    "fwd_march_ckpt": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_est_recompute": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_march": f"{PACKAGE}/csrc/dg_rhs.cu",
    "tiled_fwd_seg": f"{PACKAGE}/csrc/dg_rhs.cu",
    "tiled_rev_seg": f"{PACKAGE}/csrc/dg_rhs.cu",
    "mxu_fwd_traj": f"{PACKAGE}/csrc/dg_mxu.cu",
    "mxu_adj_est": f"{PACKAGE}/csrc/dg_mxu.cu",
    "dg_estimate_ensemble[J=int(u^2)]": f"{PACKAGE}/csrc/dg_slab.cu",
    "dg_estimate_hp_per_member[J=int(u^2)]": f"{PACKAGE}/csrc/dg_slab_mixed.cu",
    "dense_epoch_grad[bf16]": f"{PACKAGE}/csrc/train_dense_fused.cu",
    # a caller's callables traced into device functors (ops/cuda/functor.py)
    "fd_ensemble[traced]": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_ensemble_vec[traced]": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "fd_estimate_per_member[traced]": f"{PACKAGE}/csrc/fd_ensemble.cu",
    "dg_estimate_ensemble[traced]": f"{PACKAGE}/csrc/dg_slab.cu",
    "dg_estimate_hp_per_member[traced]": f"{PACKAGE}/csrc/dg_slab_mixed.cu",
    # the same kernels' instances at Np 9-16 (phase 43)
    "fwd_march[Np 9-16]": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_est_stored[Np 9-16]": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_est_recompute[Np 9-16]": f"{PACKAGE}/csrc/dg_rhs.cu",
    "adj_march[Np 9-16]": f"{PACKAGE}/csrc/dg_rhs.cu",
    "burgers_march[Np 9-16]": f"{PACKAGE}/csrc/burgers.cu",
    # F2 on traced vector ODEs of 5-15 components (phase 44)
    "fd_ensemble_vec[d 5-15]": f"{PACKAGE}/csrc/fd_ensemble.cu",
}
TPU_KERNELS = {
    "fwd_march": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:981; with no trajectory "
                 "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:1017 (_fwd_grid_kernel_b, "
                 "revolve's advance) and, at B = 1, adjoint_ode_adaptivity_tpu/ops/pallas/"
                 "dg_rhs.py:270 (_forward_kernel, the advec_dg march)",
    "adj_est_stored": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:1108",
    "fd_ensemble": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:61",
    "fd_ensemble_vec": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:201",
    "fd_estimate_per_member": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:357",
    "dg_estimate_ensemble": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab.py:92",
    "dg_estimate_hp_per_member": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab_mixed.py:99",
    "resblock_epoch_grad": "adjoint_ode_adaptivity_tpu/ops/pallas/train_fused.py:107",
    "dense_epoch_grad": "adjoint_ode_adaptivity_tpu/ops/pallas/train_dense_fused.py:136",
    "burgers_march": "adjoint_ode_adaptivity_tpu/ops/pallas/burgers.py:57 (_kernel)",
    "fwd_march_ckpt": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:880 (_fwd_ckpt_grid_kernel_b); "
                      "at B = 1 adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:510 "
                      "(_fwd_ckpt_grid_kernel)",
    "adj_est_recompute": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:908 (_adj_est_grid_kernel_b); "
                         "at B = 1 adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:538 "
                         "(_adj_est_grid_kernel) and adjoint_ode_adaptivity_tpu/ops/pallas/"
                         "dg_rhs.py:384 (_adj_estimate_kernel)",
    "adj_march": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:335 (_adjoint_kernel)",
    "tiled_fwd_seg": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_sharded.py:83 (_fwd_seg_kernel); "
                     "adjoint_ode_adaptivity_tpu/ops/pallas/dg_tiled.py:282 (_fwd_seg_grid_kernel); "
                     "per rank on the sharded paths adjoint_ode_adaptivity_tpu/ops/pallas/"
                     "dg_sharded.py:165 and adjoint_ode_adaptivity_tpu/ops/pallas/"
                     "dg_tiled_sharded.py:67",
    "tiled_rev_seg": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_sharded.py:107 (_rev_seg_kernel); "
                     "adjoint_ode_adaptivity_tpu/ops/pallas/dg_tiled.py:314 (_rev_seg_grid_kernel); "
                     "per rank on the sharded paths adjoint_ode_adaptivity_tpu/ops/pallas/"
                     "dg_sharded.py:165 and adjoint_ode_adaptivity_tpu/ops/pallas/"
                     "dg_tiled_sharded.py:67",
    "mxu_fwd_traj": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_mxu.py:151 (_fwd_traj_kernel_m)",
    "mxu_adj_est": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_mxu.py:179 (_adj_est_kernel_m)",
    # the same kernels' modes: D1 and H1 with a goal's g_u, T2's bf16 products
    "dg_estimate_ensemble[J=int(u^2)]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab.py:92 "
                                        "(g_u, :207)",
    "dg_estimate_hp_per_member[J=int(u^2)]": "adjoint_ode_adaptivity_tpu/ops/pallas/"
                                             "dg_slab_mixed.py:99 (g_u, :379)",
    "dense_epoch_grad[bf16]": "adjoint_ode_adaptivity_tpu/ops/pallas/train_dense_fused.py:136 "
                              "(mxu_dtype=bfloat16, _dot :124)",
    # the same kernels on a caller's elementwise callables, which Pallas traces
    # into the body (make_pallas_* take f, f_u, g_u, f_comps and jac_comps)
    "fd_ensemble[traced]": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:61 (f, f_u of "
                           "make_pallas_fd_ensemble, :127)",
    "fd_ensemble_vec[traced]": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:201 "
                               "(f_comps, jac_comps of make_pallas_fd_ensemble_vec, :276)",
    "fd_estimate_per_member[traced]": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:357 "
                                      "(f, f_u of make_pallas_fd_estimate_per_member, :458)",
    "dg_estimate_ensemble[traced]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab.py:92 (f, "
                                    "f_u=None, g_u of make_pallas_dg_estimate_ensemble, :236)",
    "dg_estimate_hp_per_member[traced]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_slab_mixed.py:99"
                                         " (f, f_u=None, g_u of "
                                         "make_pallas_dg_estimate_hp_per_member, :458)",
    # the same kernels at N = 8-15, which the Pallas bodies take at any order
    # their VMEM check admits
    "fwd_march[Np 9-16]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:981 "
                          "(_fwd_traj_grid_kernel_b; with no store :1017 and :270; the "
                          "checkpoints :880 and :510; KT1 dg_sharded.py:83, dg_tiled.py:282)",
    "adj_est_stored[Np 9-16]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:1108 "
                               "(_adj_est_grid_kernel_b_stored; KT2 dg_sharded.py:107, "
                               "dg_tiled.py:314)",
    "adj_est_recompute[Np 9-16]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:908 "
                                  "(_adj_est_grid_kernel_b; at B = 1 :538 and :384)",
    "adj_march[Np 9-16]": "adjoint_ode_adaptivity_tpu/ops/pallas/dg_rhs.py:335 (_adjoint_kernel)",
    "burgers_march[Np 9-16]": "adjoint_ode_adaptivity_tpu/ops/pallas/burgers.py:57 (_kernel)",
    # the vector kernel at the d its scoped-VMEM check admits past the port's
    # register design (fd_ensemble.py:326-334)
    "fd_ensemble_vec[d 5-15]": "adjoint_ode_adaptivity_tpu/ops/pallas/fd_ensemble.py:201 "
                               "(_vec_kernel at d 5-15, make_pallas_fd_ensemble_vec :276)",
}
# the JAX package's benchmark shapes: the ensemble refinement signal and its
# d=2 sibling (utils/flops.py:100-104) and the per-member study (bench.py:824-833)
FD_ENSEMBLE = dict(n_ics=102_400, n_steps=16, rf=4, dt=2.0 / 16)
FD_STUDY = dict(b=1024, maxit=40, n_steps0=2, t1=2.0, rf=4)
FD_PM_STEPS = FD_STUDY["n_steps0"] + FD_STUDY["maxit"] + 1  # max_nodes − 1
EPS32 = 2.0**-23
# the JAX package's DG-slab benchmark shapes: the ensemble pipeline
# (bench.py:589-608), its 102,400-member scale (bench.py:785-807) and the
# B=1024 adaptive studies (bench.py:696-780)
DG_SLAB = dict(b=16_384, k=16, t1=2.0, newton_iters=5, seed=1)
DG_SLAB_BIG = dict(b=102_400, seed=3)
DG_STUDY = dict(b=1024, k0=4, maxit=10, tol=0.0, newton_iters=8, seed=2)
# the JAX package's hp benchmark (bench.py:853-1006): the per-member hp study
# at B = 512 (y0 ~ U(0.5, 2) seed 5) and B = 4096 (seed 6), k0 4, orders
# 1..3 (stack n_max 5, np_max 6), maxit 10, tol 0, 8 Newton steps, sin u on [0, 2]
HP_STUDY = dict(b=512, seed=5, k0=4, n_max=3, fo=2, maxit=10, newton_iters=8, t1=2.0)
HP_BIG = dict(b=4096, seed=6)
HP_K = HP_STUDY["k0"] + HP_STUDY["maxit"] + 1
HP_ARGV = ["--hp", "hp", "--ensemble", "512", "--seed", "5", "--k0", "4", "--order", "1",
           "--n-max", "3", "--maxit", "10", "--tol", "0", "--newton-iters", "8"]
# the JAX package's training benchmarks: the per-step ResBlockSimple epoch
# (bench.py:1028-1042) and the shared Dense chain (bench.py:1183-1200)
NN_T1 = dict(s=10, f=500, b=8192, dt=0.1, seed=11, init_seed=7)
NN_T2 = dict(sizes=(100, 500), b=8192, steps=(10, 100), seed=13, init_seed=3)
NN_ARGV = ["--method", "variable_params", "--width", "500", "--n-train", "8192", "--epochs",
           "50", "--maxit", "3"]
NN_REC_ARGV = ["--method", "recurrent", "--hidden", "100,500", "--n-train", "8192", "--epochs", "2",
               "--maxit", "1"]
NN_VARIANT_ARGV = ["--width", "64", "--n-train", "1000", "--epochs", "10", "--maxit", "1"]
# bench.py:420-473's Burgers row: the headline mesh, B = 8, 2048 steps,
# dt = 0.3·x_min, ΠN limiter
BURGERS = dict(n_order=2, k=10_000, b=8, n_steps=2048, cfl=0.3)
NN_DRIFT = 1e-3  # torch vs cuda engine: per-epoch loss drift over one outer iteration
# one H100 SXM at its full power limit (NVIDIA data sheet, dense FP32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


SAID = {}  # phase -> (host clock at its first line, at its last)


def say(phase: str, msg: str) -> None:
    now = time.perf_counter()
    SAID[phase] = (SAID.get(phase, (now,))[0], now)
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 20) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls queued behind
    a device-side sleep longer than the host takes to queue them, timed by
    CUDA events, so the host's share of a call is left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)  # ~3 ms
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def in_turns(fns: dict, runs: int = 5) -> dict:
    """CUDA-event times of several versions of one computation, taken in
    turns (A, B, …, B, A): each version's median of ``runs`` twice, once on
    each side, so a drift of the card's clock or neighbours during the
    window falls on every version alike. Returns name -> (first, second)."""
    order = list(fns) + list(reversed(list(fns)))
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name], runs=runs))
    return {name: tuple(t) for name, t in times.items()}


def mesh(n_order, k, graded):
    import numpy as np

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** (1.6 if graded else 1.0)
    return startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)


def cfl_step(disc):
    import numpy as np

    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    return 0.5 * (0.75 / A) * xmin  # bench.py's CFL-stable step


def phased_states(disc, batch, device, dtype):
    """B phase-shifted sine ICs as (Np, B, K) (bench.py's batched ICs)."""
    import numpy as np
    import torch

    phases = np.linspace(0.0, 2 * np.pi, batch, endpoint=False)
    u0 = np.stack([np.sin(disc.x + p) for p in phases], axis=1)
    return torch.tensor(u0, dtype=dtype, device=device)


def batched_cotangent(disc, batch, device, dtype):
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import (
        terminal_integral_cotangent,
    )

    lam = terminal_integral_cotangent(disc, dtype, device)
    return lam[:, None, :].expand(disc.np_, batch, disc.k).contiguous()


def tolerances(n_steps, np_, u, lam):
    """float32 kernel vs plain, same tables, different operation order:
    a few ulp per step of the largest state (u), cotangent (λ), and of
    max|λ|·max|u| per node and step for η (a sum of differences of O(1)
    states). A stage's rows are Np-term dot products, each rounding Np
    times: the bound that held K1, K2, K2r and KA through Np = 8 (phase
    2(b), N = 7) grows as Np/8 above (the same values at Np ≤ 8). Noisy
    nodal data give η teeth; on smooth data at N ≥ 8 η lies below float32
    roundoff (phase 43(b) holds it there to the float64 plain run)."""
    eps = 2.0**-23
    umax, lmax = float(u.abs().max()), float(lam.abs().max())
    length = max(1.0, np_ / 8)
    return {
        "u": 8 * n_steps * eps * umax * length,
        "lam": 8 * n_steps * eps * lmax * length,
        "eta": 8 * n_steps * np_ * eps * umax * lmax * length,
    }


def compare_case(name, disc, batch, n_steps, device, errs):
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, batch, device, torch.float32)
    lam = batched_cotangent(disc, batch, device, torch.float32)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)
    torch.cuda.synchronize()
    traj_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)
    # K2 against its plain version on the SAME inputs (the kernel's trajectory)
    lam0_p, eta_p = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    tol = tolerances(n_steps, disc.np_, uf_p, lam)
    e = {
        "traj": float((traj - traj_p).abs().max()),
        "u_final": float((uf - uf_p).abs().max()),
        "lam0": float((lam0 - lam0_p).abs().max()),
        "eta": float((eta - eta_p).abs().max()),
    }
    for x in (traj, uf, lam0, eta):
        assert bool(torch.isfinite(x).all()), f"{name}: non-finite kernel output"
    say("2", f"{name}: Np={disc.np_} K={disc.k} B={batch} steps={n_steps} | "
             f"K1 traj {e['traj']:.3e} u_final {e['u_final']:.3e} (tol {tol['u']:.3e}) | "
             f"K2 lam0 {e['lam0']:.3e} (tol {tol['lam']:.3e}) eta {e['eta']:.3e} "
             f"(tol {tol['eta']:.3e}; max|eta| {float(eta_p.abs().max()):.3e})")
    assert e["traj"] <= tol["u"] and e["u_final"] <= tol["u"], f"{name}: K1 disagrees"
    assert e["lam0"] <= tol["lam"] and e["eta"] <= tol["eta"], f"{name}: K2 disagrees"
    errs["fwd_march"] = max(errs["fwd_march"], e["traj"], e["u_final"])
    errs["adj_est_stored"] = max(errs["adj_est_stored"], e["lam0"], e["eta"])


def eager_estimate(vx, n_steps, dt, device, dtype, n_order=2):
    """The ``engine="torch"`` estimate of one adaptive-loop iteration."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import advec_fwd_adj_estimate
    from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    disc = startup_1d(n_order, 0.0, 2 * np.pi, len(vx) - 1, vx=vx)
    ops = advec_operators(disc, a=A, dtype=dtype, device=device)
    u0 = torch.as_tensor(np.sin(disc.x), dtype=dtype, device=device)
    res = advec_fwd_adj_estimate(ops, disc, u0, dt, n_steps, segment=max(n_steps // 8, 1))
    return float(res.j_value), res.eta.double().cpu().numpy(), disc


def phase3(device):
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt.advec_loop import run_adaptive_advec
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    argv = ["--adapt", "--kernel", "cuda", "--k", "512", "--order", "2",
            "--final-time", "0.25", "--maxit", "4"]
    dg_rhs.reset_launch_counts()
    t0 = time.perf_counter()
    hist = advec_dg.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd_march": dg_rhs.fwd_march.launches,
                "adj_est_stored": dg_rhs.adj_est_stored.launches}
    say("3", f"main path --adapt --kernel cuda: {len(hist)} iterations, K "
             f"{len(hist[0].vx) - 1} -> {len(hist[-1].vx) - 1}, steps "
             f"{[r.n_steps for r in hist]}, wall {wall:.3f} s, wrapper launches {launches}")
    assert all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}"
    assert len(hist) == 5 and len(hist[-1].vx) - 1 == 516
    for r in hist:
        assert np.isfinite(r.j_value) and np.all(np.isfinite(r.eta))

    hist_t = advec_dg.main([a if a != "cuda" else "torch" for a in argv])
    same = [bool(np.array_equal(a.vx, b.vx)) for a, b in zip(hist, hist_t)]
    say("3", f"--kernel torch (float32 eager) vertex history equal per iteration: {same}; "
             f"Σeta cuda {[f'{r.est_total:+.3e}' for r in hist]} "
             f"torch {[f'{r.est_total:+.3e}' for r in hist_t]}")

    # Replay every mesh of the CUDA study through the eager engine (float32,
    # same card). J is a sum of O(1) states: its float32 roundoff is ~ a few
    # ulp per step·Σ|λ|. η at this size is float32 roundoff (the float64
    # signal sits below it, printed next), so it is held to the noise bound.
    eps = 2.0**-23
    for it, r in enumerate(hist):
        j_t, eta_t, disc = eager_estimate(r.vx, r.n_steps, r.dt, device, torch.float32)
        lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
        tol_j = 8 * np.sqrt(r.n_steps) * eps * float(np.sum(np.abs(lam)))
        tol_eta = 8 * np.sqrt(r.n_steps) * disc.np_ * eps * float(np.max(np.abs(lam)))
        dj, de = abs(r.j_value - j_t), float(np.max(np.abs(r.eta - eta_t)))
        say("3", f"replay it {it} K={disc.k}: |dJ| {dj:.3e} (tol {tol_j:.3e}) "
                 f"max|d eta| {de:.3e} (tol {tol_eta:.3e}) argmax cuda "
                 f"{int(np.argmax(np.abs(r.eta)))} torch {int(np.argmax(np.abs(eta_t)))}")
        assert dj <= tol_j and de <= tol_eta, f"replay it {it}: cuda vs torch engine"
    _, eta64, _ = eager_estimate(hist[0].vx, hist[0].n_steps, hist[0].dt, device,
                                 torch.float64)
    say("3", f"it 0 float64 eta: max {np.max(np.abs(eta64)):.3e} at element "
             f"{int(np.argmax(np.abs(eta64)))}, Σ {np.sum(eta64):+.3e}; float32 cuda "
             f"eta max|eta - eta64| {np.max(np.abs(hist[0].eta - eta64)):.3e}")

    # refinement decisions where the indicator sits above float32 roundoff:
    # tests/test_advec.py::TestAdaptiveAdvecPallasEngine's configuration
    kw = dict(n_order=2, k0=8, final_time=0.05, maxit=2, tol=1e-12, device=device)
    hc = run_adaptive_advec(lambda x: np.sin(3 * x), engine="cuda", **kw)
    ht = run_adaptive_advec(lambda x: np.sin(3 * x), engine="torch", dtype=torch.float32, **kw)
    assert len(hc) == len(ht)
    for a, b in zip(hc, ht):
        np.testing.assert_array_equal(a.vx, b.vx)
        np.testing.assert_allclose(a.eta, b.eta, rtol=5e-3, atol=2e-7)
    say("3", f"sin(3x) K0=8 study: cuda and torch vertex histories equal over "
             f"{len(hc)} iterations (K -> {len(hc[-1].vx) - 1}), eta within rtol 5e-3 atol 2e-7")

    err = advec_dg.main(["--estimate", "--kernel", "cuda", "--k", "512"])
    assert np.isfinite(err) and err < 1e-2
    say("3", f"--estimate --kernel cuda --k 512: march max error {err:.3e}")

    # the driver's plain march: K1 at B = 1 with no trajectory, the port of
    # the TPU's _forward_kernel (dg_rhs.py:270)
    dg_rhs.reset_launch_counts()
    err = advec_dg.main(["--kernel", "cuda", "--k", "512"])
    march = {"fwd_march": dg_rhs.fwd_march.launches,
             "adj_est_stored": dg_rhs.adj_est_stored.launches}
    say("3", f"--kernel cuda --k 512 (march only): max error {err:.3e}, wrapper launches {march}")
    assert np.isfinite(err) and err < 1e-2
    assert march == {"fwd_march": 1, "adj_est_stored": 0}, march
    return launches, hist[-1].vx


def phase4(device, errs):
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    disc = mesh(n_order, k, graded=False)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, b, device, torch.float32)
    lam = batched_cotangent(disc, b, device, torch.float32)
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, b, device,
                                                         store_trajectory=True)
    out = {}

    def pipeline():
        out["k"] = run(u0, 0.0, lam)

    t_pipe = cuda_ms(pipeline, runs=5)
    t_k1 = cuda_ms(lambda: out.update(k1=dg_rhs.fwd_march(u0, 0.0, n_steps, ops, True)), 5)
    traj, uf = out.pop("k1")
    t_k2 = cuda_ms(lambda: out.update(k2=dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)), 5)
    del traj, uf
    # the plain versions (~4 s and ~18 s a call) once each: they check the
    # kernels, their time is no yardstick of speed
    t_p1 = cuda_ms(lambda: out.update(p1=dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)),
                   runs=1, warmup=0)
    traj_p, uf_p = out.pop("p1")
    t_p2 = cuda_ms(lambda: out.update(p2=dg_rhs.adj_est_stored_plain(traj_p, uf_p, lam, 0.0, ops)),
                   runs=1, warmup=0)
    del traj_p
    uf_k, lam0_k, eta_k = out["k"]
    lam0_p, eta_p = out["p2"]
    tol = tolerances(n_steps, disc.np_, uf_p, lam)
    e = (float((uf_k - uf_p).abs().max()), float((lam0_k - lam0_p).abs().max()),
         float((eta_k - eta_p).abs().max()))
    say("4", f"kernel vs plain at the headline: u_final {e[0]:.3e} (tol {tol['u']:.3e}) "
             f"lam0 {e[1]:.3e} (tol {tol['lam']:.3e}) eta {e[2]:.3e} (tol {tol['eta']:.3e})")
    assert e[0] <= tol["u"] and e[1] <= tol["lam"] and e[2] <= tol["eta"]
    errs["fwd_march"] = max(errs["fwd_march"], e[0])
    errs["adj_est_stored"] = max(errs["adj_est_stored"], e[1], e[2])

    dof_steps = b * disc.np_ * k * 2 * n_steps
    k1_launches, k2_launches = dg_rhs.fwd_march.cuda_launches, dg_rhs.adj_est_stored.cuda_launches
    cuda_launches = k1_launches + k2_launches
    say("4", f"K={k} N={n_order} steps={n_steps} B={b} dt={dt:.6e}: kernel pipeline "
             f"{t_pipe:.3f} ms (median of 5) = {dof_steps / (t_pipe / 1e3):.4e} "
             f"fwd+adjoint DoF-steps/s [{cuda_launches} CUDA launches, "
             f"{t_pipe * 1e3 / cuda_launches:.2f} us each]; K1 {t_k1:.3f} ms ({k1_launches} "
             f"CUDA launches), K2 {t_k2:.3f} ms ({k2_launches}); K1/K2 {t_k1 / t_k2:.3f}")
    say("4", f"plain PyTorch pipeline {t_p1 + t_p2:.3f} ms (fwd {t_p1:.3f} + adj {t_p2:.3f}, "
             f"one run) = {dof_steps / ((t_p1 + t_p2) / 1e3):.4e} DoF-steps/s; "
             f"kernel speed-up {(t_p1 + t_p2) / t_pipe:.2f}x")

    ops_half = dg_rhs.kernel_ops(disc, A, dt / 2, device)
    _, uf_half = dg_rhs.fwd_march(u0, 0.0, 2 * n_steps, ops_half)
    j = torch.sum(lam * uf_k, dim=(0, 2))
    j_half = torch.sum(lam * uf_half, dim=(0, 2))
    sum_eta = eta_k.sum(dim=1)
    for m in (0, b - 1):
        say("4", f"member {m}: sum_eta {float(sum_eta[m]):+.6e}  gap J(u_dt)-J(u_dt/2) "
                 f"{float(j[m] - j_half[m]):+.6e} (float32; phase 5 checks the identity in float64)")
    for x in (uf_k, lam0_k, eta_k, uf_half):
        assert bool(torch.isfinite(x).all())
    return {"fwd_march": (t_k1, t_p1), "adj_est_stored": (t_k2, t_p2)}


def march_times(device, errs):
    """K1 as the advec_dg march (the TPU's _forward_kernel, dg_rhs.py:270):
    B = 1, no trajectory, at the driver's ``--kernel cuda --k 512`` defaults
    (N = 2, T = 2, cfl 0.75); the kernel against its plain version."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.advec import cfl_dt
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k = 2, 512
    disc = startup_1d(n_order, 0.0, 2 * np.pi, k)
    dt, n_steps = cfl_dt(disc, A, 0.75, 2.0)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = torch.tensor(np.sin(disc.x)[:, None, :], dtype=torch.float32, device=device)
    out = {}
    ms = cuda_ms(lambda: out.update(k=dg_rhs.fwd_march(u0, 0.0, n_steps, ops)[1]), runs=5)
    plain_ms = cuda_ms(lambda: out.update(p=dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops)[1]),
                       runs=1, warmup=0)
    e = float((out["k"] - out["p"]).abs().max())
    tol = 8 * n_steps * EPS32 * float(out["p"].abs().max())
    b_ms, b_by = march_bound(n_order, k, n_steps)
    say("4", f"K1 as the advec_dg march (_forward_kernel, dg_rhs.py:270) K={k} N={n_order} "
             f"B=1 steps={n_steps}: kernel {ms:.3f} ms (median of 5, "
             f"{dg_rhs.fwd_march.cuda_launches} CUDA launches); plain {plain_ms:.3f} ms "
             f"(one run); bound {b_ms:.5f} ms ({b_by}); "
             f"max|kernel - plain| {e:.3e} (tol {tol:.3e})")
    assert e <= tol, "K1 at B = 1 disagrees with its plain version"
    errs["fwd_march"] = max(errs["fwd_march"], e)


def phase5(device):
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_order, k, n_steps = HEADLINE["n_order"], HEADLINE["k"], EFFECTIVITY_STEPS
    disc = mesh(n_order, k, graded=False)
    dt = cfl_step(disc)
    f64 = torch.float64
    # bench.py's effectivity problem: u0 = sin(800x) keeps the time-error gap
    # far above float64 roundoff; J = ∫ u(T) over x in [π, π+1]
    u0 = torch.tensor(np.sin(800 * disc.x)[:, None, :], dtype=f64, device=device)
    xc = disc.x.mean(axis=0)
    window = torch.tensor((xc >= np.pi) & (xc <= np.pi + 1.0), dtype=f64, device=device)
    lam = batched_cotangent(disc, 1, device, f64) * window
    t0 = time.perf_counter()
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, True)
    _, eta = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)
    del traj
    _, uf_half = dg_rhs.fwd_march_plain(u0, 0.0, 2 * n_steps,
                                        dg_rhs.kernel_ops(disc, A, dt / 2, device))
    gap = float(torch.sum(lam * uf) - torch.sum(lam * uf_half))
    est = float(eta.sum())
    rel = abs(est - gap) / abs(gap)
    say("5", f"float64 plain path K={k} N={n_order} steps={n_steps} B=1: sum_eta {est:+.12e} "
             f"gap {gap:+.12e} |abs err| {abs(est - gap):.3e} |rel err| {rel:.3e} (limit 1e-10) [{time.perf_counter() - t0:.1f} s]")
    assert rel <= 1e-10, rel


# ------------------------------------------------------------------ FD strand


def fd_check(label, kname, got, want, tol, errs, teeth=False, phase="6"):
    """The kernel's output within ``tol`` of the plain version's; with
    ``teeth``, some entry of the plain version lies above ``tol`` (so an
    output of 0 fails)."""
    import torch

    assert bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output"
    e = float((got.double() - want.double()).abs().max())
    above = int((want.abs() > tol).sum())
    say(phase, f"{label}: max|kernel - plain| {e:.3e} (tol {tol:.3e}; max|plain| "
             f"{float(want.abs().max()):.3e}; {above} of {want.numel()} plain entries above tol)")
    assert e <= tol, f"{label}: kernel disagrees with its plain version"
    assert above > 0 or not teeth, f"{label}: no entry above the tolerance (an output of 0 passes)"
    errs[kname] = max(errs.get(kname, 0.0), e)


def fd_inputs(device):
    """The phase-6 inputs at the JAX package's benchmark shapes, from seeds:
    u0 ~ U(−3, 3) seed 0 (bench.py:508-510); the d=2 states ~ U(−1, 1) seed 21
    (bench.py:1297-1300); the per-member study's u0 ~ U(0.5, 2) seed 0
    (bench.py:824-833) on random grids of 2..43 active steps over [0, 2]
    with padded zero-width tails."""
    import numpy as np
    import torch

    n, b, s = FD_ENSEMBLE["n_ics"], FD_STUDY["b"], FD_PM_STEPS
    f32 = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(5)
    times = np.full((b, s + 1), FD_STUDY["t1"])
    for m, n_act in enumerate(rng.integers(2, s + 1, b)):
        times[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.uniform(0.0, FD_STUDY["t1"], n_act - 1)), [FD_STUDY["t1"]]])
    return {
        "u0": torch.tensor(np.random.default_rng(0).uniform(-3, 3, n), **f32),
        "u0_vec": torch.tensor(np.random.default_rng(21).uniform(-1, 1, (n, 2)), **f32),
        "u0_pm": torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, b), **f32),
        "dt_pm": torch.tensor(np.diff(times, axis=1), **f32).contiguous(),
        # a graded (nonuniform) coarse grid over [0, 2]
        "dt_graded": np.diff(2.0 * np.linspace(0.0, 1.0, FD_ENSEMBLE["n_steps"] + 1) ** 1.5),
    }


def phase6(device, errs, inp):
    """Each FD kernel against its plain version on the card, float32."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_ics", "n_steps", "rf", "dt"))
    u0 = inp["u0"]

    def ensemble(label, ode, step, trig="libm", x=u0):
        run = fe.make_cuda_fd_ensemble(ode, s, rf, step, trig=trig, device=device)
        got = run(x)
        torch.cuda.synchronize()
        stats = {}
        want = fe.fd_ensemble_plain(x, run.plan, stats)
        fd_check(label, "fd_ensemble", got, want, fe.fd_kernel_tolerance(stats, rf), errs)

    for trig in ("libm", "fast"):
        ensemble(f"(a) sin(u) {n} ICs, uniform dt, trig={trig}", "du/dt=sin(u)", dt, trig)
    ensemble("(b) sin(u), graded dt vector", "du/dt=sin(u)", inp["dt_graded"])
    ensemble("(c) gaussian_mixture (time-dependent RHS)", "gaussian_mixture", dt)
    for ode in ("du/dt=u", "du/dt=cos(2*pi*u)", "du/dt=10cos(u)", "du/dt=t*sin(u)"):
        ensemble(f"(c') {ode} at 4096 ICs", ode, dt, x=u0[:4096] / 3)

    run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    got = run(inp["u0_vec"])
    torch.cuda.synchronize()
    stats = {}
    want = fe.fd_ensemble_vec_plain(inp["u0_vec"], run.plan, stats)
    fd_check(f"(d) harmonic_oscillator d=2, {n} ICs", "fd_ensemble_vec", got, want,
             fe.fd_kernel_tolerance(stats, rf, d=2), errs)

    dt_pm, u0_pm = inp["dt_pm"], inp["u0_pm"]
    t_max = float(dt_pm.double().sum(1).max())
    for ode in ("du/dt=sin(u)", "gaussian_mixture"):
        for conv in ("strided", "block"):
            run = fe.make_cuda_fd_estimate_per_member(ode, FD_PM_STEPS, rf, conv, device=device)
            err_k, j_k = run(dt_pm, u0_pm)
            torch.cuda.synchronize()
            stats = {}
            err_p, j_p = fe.fd_estimate_per_member_plain(dt_pm, u0_pm, run.plan, stats)
            label = f"(e) per-member {ode} B={u0_pm.shape[0]} {FD_PM_STEPS} steps {conv}"
            fd_check(label + " err", "fd_estimate_per_member", err_k, err_p,
                     fe.fd_kernel_tolerance(stats, rf), errs, teeth=True)
            fd_check(label + " J", "fd_estimate_per_member", j_k, j_p,
                     fe.fd_j_tolerance(stats, FD_PM_STEPS, t_max), errs)
            assert err_k.shape == dt_pm.shape and err_k.is_contiguous()
            # zero-width padded steps contribute exactly 0
            pad = dt_pm == 0
            assert bool((err_k[pad] == 0).all()), "padding steps must contribute exactly 0"

    # the wrappers refuse what the kernels do not take; nothing falls back
    run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, device=device)
    for bad, exc in ((u0.double(), TypeError), (u0[::2], ValueError)):
        try:
            run(bad)
        except exc:
            continue
        raise AssertionError(f"the kernel wrapper took a {bad.dtype} stride-{bad.stride()} input")
    say("6", "float64 and non-contiguous inputs raise; no plain-version fallback on the card")


def study_u0s():
    """The driver's ensemble: U(u0/2, 2·u0) with u0 = 1, seed 0 (as bench.py:824-833)."""
    import numpy as np

    return np.random.default_rng(0).uniform(0.5, 2.0, FD_STUDY["b"])


def fd_replay(hist, device, errs):
    """Every iteration's grids of the B = 1024 per-member FD study (u0 from
    :func:`study_u0s`) through F3's plain version (float32, same card, held
    to fd_kernel_tolerance and fd_j_tolerance, with entries above it) and
    through the torch engine's estimate on the same grids (not bounded:
    another operation order); the refinement decisions whose top-two margin
    clears 4x the tolerance must agree in all three (a gate)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    rf = FD_STUDY["rf"]
    u0s = torch.tensor(study_u0s(), dtype=torch.float32, device=device)
    plan = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf,
                                               device=device).plan
    step = euler_step(odes.get_ode("du/dt=sin(u)").f)
    out = {"err": 0.0, "tol_err": 0.0, "j": 0.0, "tol_j": 0.0, "torch": 0.0, "decided": 0,
           "agree": 0, "teeth": []}
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        stats = {}
        err_p, j_p = fe.fd_estimate_per_member_plain(torch.diff(times, dim=1), u0s, plan, stats)
        n_act = torch.tensor(r.n_active, device=device)
        err_t = fd_loop.estimate_per_member(step, times, n_act, u0s, ref_factor=rf)[0]
        err_k = torch.tensor(r.err_steps, device=device)
        tol_e = fe.fd_kernel_tolerance(stats, rf)
        tol_j = fe.fd_j_tolerance(stats, FD_PM_STEPS, FD_STUDY["t1"])
        e_err = float((err_k - err_p).abs().max())
        e_j = float((torch.tensor(r.j_coarse, device=device) - j_p).abs().max())
        assert e_err <= tol_e and e_j <= tol_j, (e_err, tol_e, e_j, tol_j)
        above = int((err_p.abs() > tol_e).sum())
        out["teeth"].append(above)
        assert above > 0, "a replayed grid with no err above its tolerance (an err of 0 passes)"
        for key, val in (("err", e_err), ("tol_err", tol_e), ("j", e_j), ("tol_j", tol_j),
                         ("torch", float((err_k - err_t).abs().max()))):
            out[key] = max(out[key], val)
        # refinement decisions where the top-two margin clears the noise
        top2 = torch.topk(err_p, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 4 * tol_e
        picks = [torch.argmax(x, dim=1) for x in (err_k, err_p, err_t)]
        same = (picks[0] == picks[1]) & (picks[1] == picks[2])
        out["decided"] += int(clear.sum())
        out["agree"] += int((same & clear).sum())
    errs["fd_estimate_per_member"] = max(errs["fd_estimate_per_member"], out["err"], out["j"])
    assert out["agree"] == out["decided"], "a decision above the float32 noise differs between engines"
    return out


def phase7(device, errs, inp):
    """The FD paths through their entry points: the per-member study via the
    fd_adaptive driver (per-member kernel), the ensemble refinement signal
    via its entry points (F1, F1 fast, F2), and the single-run default."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    b, maxit, rf = FD_STUDY["b"], FD_STUDY["maxit"], FD_STUDY["rf"]
    argv = ["--ensemble", str(b), "--engine", "cuda", "--device-loop", "--tol", "0",
            "--maxit", str(maxit)]
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    hist = fd_adaptive.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fd_estimate_per_member": fe.fd_estimate_per_member.launches}
    say("7", f"main path fd_adaptive {' '.join(argv)}: {len(hist)} iterations, steps "
             f"{hist[0].n_active.max()} -> [{hist[-1].n_active.min()}..{hist[-1].n_active.max()}], "
             f"wall {wall:.3f} s, wrapper launches {launches}")
    assert launches["fd_estimate_per_member"] > 0, "the per-member kernel was not launched"
    assert len(hist) == maxit + 1
    for r in hist:
        assert np.all(np.isfinite(r.err_steps)) and np.all(np.isfinite(r.j_coarse))

    rep = fd_replay(hist, device, errs)
    say("7", f"replay of {len(hist)} grids through the plain version: max|d err| "
             f"{rep['err']:.3e} (tol <= {rep['tol_err']:.3e}), max|d J| {rep['j']:.3e} "
             f"(tol <= {rep['tol_j']:.3e}); entries of the plain err above its tolerance a "
             f"grid {min(rep['teeth'])}-{max(rep['teeth'])}; torch engine on the same grids: "
             f"max|d err| {rep['torch']:.3e} (not bounded: another operation order)")
    say("7", f"refinement decisions with a top-two margin > 4x tol: {rep['decided']} of "
             f"{len(hist) * b} member-iterations; kernel, plain and torch engine agree on "
             f"{rep['agree']}")

    # the ensemble refinement signal through its entry points
    n, s, dt = FD_ENSEMBLE["n_ics"], FD_ENSEMBLE["n_steps"], FD_ENSEMBLE["dt"]
    sig = {}
    fe.reset_launch_counts()
    for trig in ("libm", "fast"):
        run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig=trig, device=device)
        sig[trig] = run(inp["u0"]).mean(dim=1)
    vec = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    sig["vec"] = vec(inp["u0_vec"]).mean(dim=1)
    torch.cuda.synchronize()
    launches["fd_ensemble"] = fe.fd_ensemble.launches
    launches["fd_ensemble_vec"] = fe.fd_ensemble_vec.launches
    for key, x in sig.items():
        assert x.shape == (s,) and bool(torch.isfinite(x).all()), key
    stats = {}
    ref64 = fe.fd_ensemble_plain(inp["u0"].double(), run.plan, stats).mean(dim=1)
    d64 = float((sig["libm"].double() - ref64).abs().max())
    top2 = torch.topk(ref64, 2).values
    say("7", f"ensemble signal ({n} ICs, {s} steps, rf {rf}): argmax libm "
             f"{int(sig['libm'].argmax())} fast {int(sig['fast'].argmax())} float64 plain "
             f"{int(ref64.argmax())} (top-two margin {float(top2[0] - top2[1]):.3e}); "
             f"max|signal - float64| {d64:.3e}; d=2 signal argmax {int(sig['vec'].argmax())}; "
             f"wrapper launches {launches}")
    assert d64 <= fe.fd_kernel_tolerance(stats, rf), "the float32 signal is off its float64 plain version"
    if float(top2[0] - top2[1]) > fe.fd_kernel_tolerance(stats, rf):  # above the noise
        assert int(sig["libm"].argmax()) == int(sig["fast"].argmax()) == int(ref64.argmax())
    assert all(launches[k] > 0 for k in ("fd_ensemble", "fd_ensemble_vec"))

    # the single-run default: sin(u), J = ∫u², maxit 40, torch on the card
    t0 = time.perf_counter()
    single = fd_adaptive.main([])
    torch.cuda.synchronize()
    e0, e1 = float(single[0].err_total), float(single[-1].err_total)
    say("7", f"fd_adaptive default (single run, float32 on the card): {len(single)} iterations, "
             f"sum(err) {e0:.4e} -> {e1:.4e}, wall {time.perf_counter() - t0:.2f} s")
    assert np.isfinite(e1) and e1 < e0
    return launches


def study_times(device):
    """Phase 8 for the study: the B = 1024, maxit 40 per-member study
    (device loop) with the cuda and the torch engine, CUDA events around
    the loop call."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    ode = odes.get_ode("du/dt=sin(u)")
    kw = dict(n_steps0=FD_STUDY["n_steps0"], tol=0.0, maxit=FD_STUDY["maxit"],
              dtype=torch.float32, device=device, device_loop=True, ode=ode)

    def study(engine):
        fd_loop.run_adaptive_fd_per_member(euler_step(ode.f), study_u0s(), (0.0, FD_STUDY["t1"]),
                                           engine=engine, **kw)

    before = fe.fd_estimate_per_member.launches
    ms_cuda = cuda_ms(lambda: study("cuda"), runs=5)
    per_study = (fe.fd_estimate_per_member.launches - before) / 6
    ms_torch = cuda_ms(lambda: study("torch"), runs=1, warmup=0)
    its = FD_STUDY["maxit"] + 1
    say("8", f"per-member study B={FD_STUDY['b']} maxit {FD_STUDY['maxit']} (device loop): "
             f"engine cuda {ms_cuda:.3f} ms (median of 5; {per_study:g} kernel launches per "
             f"study, {ms_cuda / its:.3f} ms per iteration, "
             f"{FD_STUDY['b'] * its / (ms_cuda / 1e3):.4e} member-iterations/s); engine torch "
             f"{ms_torch:.1f} ms (one run); speed-up {ms_torch / ms_cuda:.1f}x")
    return ms_cuda, ms_torch


def fd_times(device, inp):
    """Phase 8 for the kernels: CUDA events, one warm-up, median of 5, each
    FD kernel and its plain version at the phase-6 shapes. Returns
    {name: (kernel ms, plain ms)}."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_ics", "n_steps", "rf", "dt"))
    u0, u0v, dt_pm, u0_pm = inp["u0"], inp["u0_vec"], inp["dt_pm"], inp["u0_pm"]
    sin_ = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, device=device)
    fast = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig="fast", device=device)
    vec = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf, device=device)
    cases = {
        "fd_ensemble": (lambda: sin_(u0), lambda: fe.fd_ensemble_plain(u0, sin_.plan),
                        fe.fd_ensemble, n),
        "fd_ensemble trig=fast": (lambda: fast(u0), lambda: fe.fd_ensemble_plain(u0, fast.plan),
                                  fe.fd_ensemble, n),
        "fd_ensemble_vec": (lambda: vec(u0v), lambda: fe.fd_ensemble_vec_plain(u0v, vec.plan),
                            fe.fd_ensemble_vec, n),
        "fd_estimate_per_member": (lambda: pm(dt_pm, u0_pm),
                                   lambda: fe.fd_estimate_per_member_plain(dt_pm, u0_pm, pm.plan),
                                   fe.fd_estimate_per_member, FD_STUDY["b"]),
    }
    bounds = fd_bounds()
    times = {}
    for name, (kern, plain, wrapper, n_ic) in cases.items():
        before = wrapper.launches
        ms = cuda_ms(kern, runs=5)
        per_call = (wrapper.launches - before) / 6
        plain_ms = cuda_ms(plain, runs=5)
        b_ms, b_by = bounds[name.split()[0]]
        say("8", f"{name}: kernel {ms:.4f} ms = {n_ic / (ms / 1e3):.4e} ICs/s "
                 f"({per_call:g} launch per call); plain {plain_ms:.3f} ms = "
                 f"{n_ic / (plain_ms / 1e3):.4e} ICs/s; kernel speed-up {plain_ms / ms:.1f}x; "
                 f"bound {b_ms:.5f} ms ({b_by}), kernel at {b_ms / ms:.2%} of it")
        times[name] = (ms, plain_ms)
    return times


def fd_bounds(n_ics=None, pairs=(2, 1, 2), grid_ops=(0, 0), f_ops=(1, 1, 1)):
    """Least time on the card for each FD kernel at the phase-6/8 shapes (F1
    and F2 at ``n_ics`` ICs where given):
    the larger of bytes (each input read once, each output written once)
    over 3.35 TB/s and FP32 operations over 67 TFLOP/s, counting an FMA as
    2 and each sin, cos or exp as 1 (the least a special-function unit can
    take). The (f, f_u) pair costs what its functor does: sin and cos for
    sin(u); one product (−4·u₀) for the harmonic oscillator, whose Jacobian
    is constant. Per IC, a fine node costs 15.25 (d=1) or 27.5 (d=2)
    operations at rf 4. ``pairs`` are the pair's operations of F1, F2 and
    F3 on each IC's or member's state (a traced functor's, phase 42), and
    ``grid_ops`` those of F1 and F2 on t alone, needed once a fine node of
    the grid that every IC shares. The forward march evaluates f alone at
    each coarse step: ``f_ops`` are its operations on the state (F1, F2,
    F3; sin u and −4·u₀ take 1); its terms in t alone are those of the fine
    node at the same time, counted there."""
    n, s, rf = n_ics or FD_ENSEMBLE["n_ics"], FD_ENSEMBLE["n_steps"], FD_ENSEMBLE["rf"]
    b, sp = FD_STUDY["b"], FD_PM_STEPS
    grid = 4 * (2 * s + 2 * s * rf)

    def node_ops(d, pair):  # interpolation, v update, residual, r·v per component; the pair
        return d * (3 * (rf - 1) / rf + 6 + 3 + 2) + pair

    sin_node, harmonic_node, pm_node = (node_ops(1, pairs[0]), node_ops(2, pairs[1]),
                                        node_ops(1, pairs[2]))
    work = {
        "fd_ensemble": (4 * n + 4 * s * n + grid,
                        n * ((2 + f_ops[0]) * s + s * rf * sin_node + s)
                        + s * rf * grid_ops[0]),
        "fd_ensemble_vec": (8 * n + 4 * s * n + grid,
                            n * ((4 + f_ops[1]) * s + s * rf * harmonic_node + s)
                            + s * rf * grid_ops[1]),
        # + J (3/step), t (1/step), fine times and widths (3/node)
        "fd_estimate_per_member": (4 * b + 8 * sp * b + 4 * b,
                                   b * ((6 + f_ops[2]) * sp + sp * rf * (pm_node + 3) + sp)),
    }
    return {k: bound(*v) for k, v in work.items()}


def bound(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def dg_bounds():
    """The same for K1 and K2 at the headline (K = 10^4, N = 2, B = 8, 2048
    steps, stored trajectory). One LSRK stage costs 2Np² + 9Np + 4
    operations per column (volume product, lift, stage update); K1 runs 5
    stages a step, K2 20 (two dt/2 steps and two transposed dt/2 steps) plus
    the η accumulation. K1 writes the trajectory; K2 reads it. D1 at
    bench.py's DG-slab shape (phase 9(a)), counted by :func:`dg_slab_bound`."""
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators

    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    np_ = n_order + 1
    cols, state = b * k, 4 * (n_order + 1) * b * k
    stage = stage_ops(np_)
    geom = 3 * 4 * k
    return {
        "fwd_march": bound(state + geom + n_steps * state + state,
                           n_steps * 5 * stage * cols),
        "adj_est_stored": bound(n_steps * state + 2 * state + geom + state + 4 * cols,
                                n_steps * (20 * stage + 3 * np_) * cols),
        "dg_estimate_ensemble": dg_slab_bound(
            1, DG_SLAB["k"], DG_SLAB["b"], DG_SLAB["newton_iters"],
            dg_time_operators(1).phi.shape[0], dg_time_operators(2).phi.shape[0]),
    }


def stage_ops(np_):
    """FP32 operations of one LSRK stage per column (see dg_bounds)."""
    return 2 * np_ * np_ + 9 * np_ + 4


def march_bound(n_order, k, n_steps):
    """K1 as the advec_dg march: B = 1, no trajectory; u0 and the geometry
    read once, u_final written once, 5 stages a step."""
    np_ = n_order + 1
    state = 4 * np_ * k
    return bound(2 * state + 3 * 4 * k, n_steps * 5 * stage_ops(np_) * k)


# ------------------------------------------------------------ DG-in-time strand


def d1_shares(got, want, tol):
    """Per output (u, v, err): max|kernel − plain| and its worst share of
    dg_kernel_tolerance's per-element bound (a bound of 0 takes only an
    exact 0)."""
    return shares(("u", "v", "err"), got, want, tol)


def shares(names, got, want, tol):
    """Per output ``names``: max|kernel − plain| and its worst share of the
    per-element bound ``tol[name]`` (a bound of 0 takes only an exact 0)."""
    e, share = {}, {}
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and bool(g.isfinite().all()), name
        d = (g - w).abs().double()
        e[name] = float(d.max())
        share[name] = float((d / tol[name]).nan_to_num(0.0, posinf=float("inf")).max())
    return e, share


def dg_case(label, device, errs, ode="du/dt=sin(u)", n=1, k=DG_SLAB["k"], b=DG_SLAB["b"],
            seed=DG_SLAB["seed"], newton_iters=DG_SLAB["newton_iters"], trig="libm",
            per_member=False):
    """One phase-9 comparison: D1 against its plain version on the card,
    through the wrapper and on every (G, CTA size) d1_plan chooses from."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    rng = np.random.default_rng(seed)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:  # random partitions of [0, 2] with zero-width tails
        t = np.full((b, k + 1), DG_SLAB["t1"])
        for m, n_act in enumerate(rng.integers(2, k - 3, b)):
            t[m, : n_act + 1] = np.concatenate(
                [[0.0], np.sort(rng.uniform(0.0, DG_SLAB["t1"], n_act - 1)), [DG_SLAB["t1"]]])
    else:
        t = np.linspace(0.0, DG_SLAB["t1"], k + 1)
    times = torch.tensor(t, dtype=torch.float32, device=device)
    ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
    run = ds.make_cuda_dg_estimate_ensemble(ode, ops_p, ops_a, k, newton_iters, trig=trig,
                                            device=device)
    got = run(times, y0)
    torch.cuda.synchronize()
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
    e, share = d1_shares(got, want, tol)
    teeth = int((want[2].abs() > tol["err"]).sum())
    worst = dict(share)
    for g in ds.LANES:
        for th in ds.CTA_THREADS:
            launch = ds.D1Launch(g, th)
            first = ds._d1_launch(times, y0, run.plan, launch)
            again = ds._d1_launch(times, y0, run.plan, launch)
            torch.cuda.synchronize()
            assert all(bool(torch.equal(x, y)) for x, y in zip(first, again)), (label, launch)
            e_l, share_l = d1_shares(first, want, tol)
            for x in e:
                e[x], worst[x] = max(e[x], e_l[x]), max(worst[x], share_l[x])
    plan = ds.d1_plan(b, ops_p.np_, max(ops_p.phi.shape[0], ops_a.phi.shape[0]))
    say("9", f"{label}: {ode} order {n} K={k} B={b} newton {newton_iters} trig={trig} "
             f"{'per-member' if per_member else 'shared'} times, the wrapper on {plan} | max|kernel "
             f"- plain| over it and {len(ds.LANES) * len(ds.CTA_THREADS)} (G, CTA size) launches: "
             + " ".join(f"{x} {e[x]:.3e} (per-element tol <= {float(tol[x].max()):.3e}, worst "
                        f"{worst[x]:.2%} of it; the wrapper {share[x]:.2%})" for x in e)
             + f"; max|err| {float(want[2].abs().max()):.3e}, {teeth} of {want[2].numel()} "
               f"elements above their err bound; every launch bit-identical on a repeat")
    assert max(worst.values()) <= 1.0, f"{label}: the DG slab kernel disagrees"
    assert teeth > 0, f"{label}: the err bound cannot tell an err of 0 from the plain version's"
    if per_member:  # a trailing zero-width slab contributes exactly 0
        pad = torch.diff(times, dim=1) == 0
        assert bool(pad.any()) and bool((got[2][pad] == 0).all()), "padding must contribute 0"
        say("9", f"{label}: {int(pad.sum())} zero-width padding slabs, every contribution "
                 f"exactly 0")
    errs["dg_estimate_ensemble"] = max(errs.get("dg_estimate_ensemble", 0.0), *e.values())
    return run, times, y0


def phase9(device, errs):
    """The DG slab kernel against its plain version on the card, float32."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    cases = {}
    for trig in ("libm", "fast"):
        cases[trig] = dg_case(f"(a) bench shapes, {trig}", device, errs, trig=trig)
    # orders 2 and 4 on coarse slabs and fast dynamics: err above float32 roundoff
    dg_case("(b) order 2 (Cramer)", device, errs, n=2, k=2, b=1024, newton_iters=8)
    dg_case("(b') order 4 (pivoted elimination)", device, errs, ode="du/dt=10cos(u)", n=4, k=4,
            b=1024, newton_iters=8)
    cases["study"] = dg_case("(c) per-member partitions", device, errs,
                             k=DG_STUDY["k0"] + DG_STUDY["maxit"] + 1, b=DG_STUDY["b"],
                             newton_iters=DG_STUDY["newton_iters"], per_member=True)
    for ode, k in (("du/dt=t*sin(u)", DG_SLAB["k"]), ("gaussian_mixture", 4)):
        dg_case(f"(d) {ode}", device, errs, ode=ode, k=k, b=4096)
    cases["big"] = dg_case("(e) 102,400 members", device, errs, b=DG_SLAB_BIG["b"],
                           seed=DG_SLAB_BIG["seed"])
    run, times, y0 = cases["libm"]
    for bad in (lambda: run(times.double(), y0), lambda: run(times, y0[::2])):
        try:
            bad()  # float64, then a non-contiguous operand
        except ValueError:
            continue
        raise AssertionError("the DG slab wrapper took an input it must refuse")
    try:
        run(times, y0[:0])  # an empty grid: the launch is refused
    except RuntimeError as exc:
        say("9", f"float64 and non-contiguous inputs raise; a refused launch raises ({exc})")
    else:
        raise AssertionError("a refused launch did not raise")
    torch.cuda.synchronize()
    ds.reset_launch_counts()
    return cases


def dg_decisions(err_a, err_b, noise):
    """Members whose top-two |err| margin (of ``err_b``) clears 4x the noise
    (a number, or one a member), and how many of them both sides refine at
    the same element."""
    import torch

    top2 = torch.topk(err_b.abs(), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * noise
    same = torch.argmax(err_a.abs(), dim=1) == torch.argmax(err_b.abs(), dim=1)
    return int(clear.sum()), int((same & clear).sum())


def phase10(device, errs):
    """The DG-in-time paths through their entry points."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    argv = ["--ensemble", "1024", "--per-member", "--device-loop"]
    ds.reset_launch_counts()
    t0 = time.perf_counter()
    hist = dg_adaptive.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dg_estimate_ensemble": ds.dg_estimate_ensemble.launches}
    last = hist[-1]
    say("10", f"main path dg_adaptive {' '.join(argv)}: {len(hist)} iterations, K "
              f"{hist[0].n_active.max()} -> [{last.n_active.min()}..{last.n_active.max()}], "
              f"{last.n_refining} of 1024 still refining, wall {wall:.3f} s, wrapper launches "
              f"{launches}")
    assert launches["dg_estimate_ensemble"] > 0, "the DG slab kernel was not launched"
    for r in hist:
        assert np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j))

    rep = dg_replay(hist, device, errs)
    say("10", f"replay of {len(hist)} iterations' partitions through the plain version: max|d err| "
              f"{rep['err']:.3e} (per-element tol <= {rep['tol']:.3e}, worst "
              f"{rep['share']:.2%} of it); decisions with a top-two margin > 4x the member's "
              f"largest err bound: {rep['decided']} of {len(hist) * 1024} member-iterations, "
              f"kernel and plain agree on {rep['agree']}; against the float64 torch engine "
              f"{rep['decided64']} clear it, agreement on {rep['agree64']}")

    ens = dg_adaptive.main(["--ensemble", "1024"])
    torch.cuda.synchronize()
    say("10", f"dg_adaptive --ensemble 1024 (shared partition, cuda engine): {len(ens)} iterations, "
              f"K {len(ens[0].times) - 1} -> {len(ens[-1].times) - 1}, mean Adj-W Res "
              f"{ens[0].est_total_mean:+.4e} -> {ens[-1].est_total_mean:+.4e}")
    assert np.isfinite(ens[-1].est_total_mean) and len(ens[-1].times) > len(ens[0].times)

    t0 = time.perf_counter()
    card = dg_adaptive.main(["--maxit", "30"])
    wall = time.perf_counter() - t0
    cpu = dg_adaptive.main(["--maxit", "30", "--device", "cpu"])
    assert len(card) == len(cpu)
    diff = 0.0
    for a, b in zip(card, cpu):
        assert np.array_equal(a.times, b.times)
        for f in ("u", "v", "err"):
            diff = max(diff, float(np.max(np.abs(getattr(a, f) - getattr(b, f)))))
        for f in ("j_coarse", "j_fine", "est_total"):
            diff = max(diff, abs(getattr(a, f) - getattr(b, f)))
    say("10", f"dg_adaptive --maxit 30 (float64 on the card): {len(card)} iterations, K="
              f"{len(card[-1].times) - 1}, Σerr {card[0].est_total:+.4e} -> "
              f"{card[-1].est_total:+.4e}, wall {wall:.2f} s; equal partitions to --device cpu, "
              f"max value difference {diff:.3e} (limit 1e-12)")
    assert diff <= 1e-12
    return launches


def dg_replay(hist, device, errs, g_u=None, key="dg_estimate_ensemble"):
    """Every iteration's partitions of the B = 1024 per-member DG study (y0
    ~ U(0.5, 2) from ``default_rng(0)``, the driver's draw) through the
    plain version (float32, same card, held to D1's per-element err bound)
    and the torch engine in float64 (decisions only): the decisions of
    members whose top-two |err| margin clears 4x the member's largest err
    bound. ``g_u`` the study's goal (None: J = ∫u); the worst |d err| goes
    to ``errs[key]``."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import dg_estimate_batched
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    sin = odes.get_ode("du/dt=sin(u)")
    y0s = np.random.default_rng(0).uniform(0.5, 2.0, 1024)
    k = hist[0].times.shape[1] - 1
    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    plan = ds.make_cuda_dg_estimate_ensemble(sin, ops_p, ops_a, k, 8, g_u=g_u,
                                             device=device).plan
    y32 = torch.tensor(y0s.astype(np.float32), device=device)
    y64 = torch.tensor(y0s.astype(np.float32).astype(np.float64), device=device)
    out = dict(decided=0, agree=0, decided64=0, agree64=0, err=0.0, share=0.0, tol=0.0)
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        plain = ds.dg_estimate_ensemble_plain(times, y32, plan)
        tol = ds.dg_kernel_tolerance(times, y32, plain, plan)["err"]
        err_k = torch.tensor(r.err, dtype=torch.float32, device=device)
        d_err = (err_k - plain[2]).abs().double()
        assert bool((d_err <= tol).all()), (float(d_err.max()), float(tol.max()))
        out["err"], out["tol"] = max(out["err"], float(d_err.max())), max(out["tol"],
                                                                          float(tol.max()))
        out["share"] = max(out["share"], float((d_err / tol).nan_to_num(0.0).max()))
        noise = tol.amax(dim=1)  # each member's largest err bound
        err64 = dg_estimate_batched(ops_p, ops_a, sin.f, times.double(), y64, f_u=sin.f_u,
                                    g_u=plan.functors.g_u, newton_iters=8)[2]
        for tag, (d, a) in (("", dg_decisions(err_k, plain[2], noise)),
                            ("64", dg_decisions(err_k.double(), err64, noise))):
            out["decided" + tag] += d
            out["agree" + tag] += a
    errs[key] = max(errs[key], out["err"])
    assert out["decided"] > 0, "no decision of the study clears the float32 bound"
    assert out["agree"] == out["decided"] and out["agree64"] == out["decided64"], (
        "a decision above the float32 noise differs", out)
    return out


def solve_ops(m):
    """FP32 operations of one m×m solve by elimination (a division per row)
    and back substitution, the least count, whatever the kernel runs (Cramer
    for m ≤ 4 costs more, and the bound does not charge that choice)."""
    elim = sum((m - c - 1) * (1 + 2 * (m - c - 1) + 2) for c in range(m))
    return elim + sum(2 * (m - i - 1) + 1 for i in range(m))


def dg_slab_bound(n, k, b, newton_iters, nqp, nqa, per_member=False, goal=False, pair=2, gu=1):
    """Least time on the card for one D1 call: the larger of bytes (times
    and y0 read once, u, v and err written once) over 3.35 TB/s and FP32
    operations over 67 TFLOP/s, counted from the kernel's loops — an FMA
    as 2, a division or a sin or cos as 1, the (f, f_u) pair of sin u as 2.
    Per member-element: newton_iters × (Nq_p points of 2Np² + 4Np + 4, the
    residual and Jacobian assembly, one Np×Np solve) and the order-(n+1)
    sweep (Nq_a points of 2Na² + 2Na + 2Np + 4, the assembly, one Na×Na
    solve and vᵀres); a ``goal`` other than J = ∫u adds g_u at the Na nodes
    and the Na² FMAs of M·g_u. ``pair`` and ``gu`` are the operations of
    the (f, f_u) pair and of g_u (a traced functor's, phase 42)."""
    np_, na = n + 1, n + 2
    fwd = newton_iters * (nqp * (2 * np_ * np_ + 4 * np_ + 2 + pair) + 4 * np_ * np_ + 3 * np_
                          + 1 + solve_ops(np_))
    adj = (2 * na * np_ + nqa * (2 * na * na + 2 * na + 2 * np_ + 2 + pair) + 2 * na * na + na
           + 1 + solve_ops(na) + na * (2 * na + 5) + (gu * na + 2 * na * na if goal else 0))
    n_bytes = 4 * ((k + 1) * (b if per_member else 1) + b + b * k * (np_ + na + 1))
    return bound(n_bytes, b * k * (fwd + adj))


def dg_times(device, cases):
    """Phase 11: CUDA events, one warm-up, median of 5, D1 and its plain
    version at 9(a) (libm and fast), 9(e) and 9(c) (one iteration of the
    per-member study); the B=1024 studies with each engine. Returns
    (kernel ms, plain ms) at 9(a) libm for the kernel line."""
    from unittest import mock

    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    out = {}
    for key, label in (("libm", "9(a) libm"), ("fast", "9(a) trig=fast"), ("big", "9(e)"),
                       ("study", "9(c), the studies' shape")):
        run, times, y0 = cases[key]
        b, k = y0.shape[0], run.plan.n_elements
        one = ds.D1Launch(1, ds.D1_THREADS)
        turns = in_turns({"wrapper": lambda: run(times, y0),
                          "one lane": lambda: ds._d1_launch(times, y0, run.plan, one)})
        ms, ms1 = statistics.mean(turns["wrapper"]), statistics.mean(turns["one lane"])
        plain_ms = cuda_ms(lambda: ds.dg_estimate_ensemble_plain(times, y0, run.plan), runs=5)
        b_ms, b_by = dg_slab_bound(1, k, b, run.plan.newton_iters, run.plan.ops_p.phi.shape[0],
                                   run.plan.ops_a.phi.shape[0], per_member=times.dim() == 2)
        nq = max(run.plan.ops_p.phi.shape[0], run.plan.ops_a.phi.shape[0])
        say("11", f"dg_estimate_ensemble {label} B={b} K={k}: kernel on "
                  f"{ds.d1_plan(b, run.plan.ops_p.np_, nq)} {ms:.4f} ms = "
                  f"{b * k * 2 / (ms / 1e3):.4e} slab-solves/s, on one lane a member ({one}) "
                  f"{ms1:.4f} ms (in turns, median of 5 each: {turns['wrapper'][0]:.4f} / "
                  f"{turns['wrapper'][1]:.4f} and {turns['one lane'][0]:.4f} / "
                  f"{turns['one lane'][1]:.4f}); plain {plain_ms:.3f} ms; kernel speed-up "
                  f"{plain_ms / ms:.1f}x; bound {b_ms:.5f} ms ({b_by}), kernel at {b_ms / ms:.2%} "
                  f"of it")
        out[label] = (ms, plain_ms)

    sin = odes.get_ode("du/dt=sin(u)")
    y0s = np.random.default_rng(DG_STUDY["seed"]).uniform(0.5, 2.0, DG_STUDY["b"])
    kw = dict(f_u=sin.f_u, k0=DG_STUDY["k0"], maxit=DG_STUDY["maxit"], tol=DG_STUDY["tol"],
              newton_iters=DG_STUDY["newton_iters"], ode=sin, device_loop=True,
              dtype=torch.float32, device=device)
    its = DG_STUDY["maxit"] + 1
    for name in ("run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"):
        loop = getattr(dg_loop, name)
        ms_cuda = cuda_ms(lambda: loop(sin.f, y0s, (0.0, 2.0), engine="cuda", **kw), runs=5)
        ms_torch = cuda_ms(lambda: loop(sin.f, y0s, (0.0, 2.0), engine="torch", **kw), runs=1,
                           warmup=0)
        say("11", f"{name} B={DG_STUDY['b']} k0 {DG_STUDY['k0']} maxit {DG_STUDY['maxit']} "
                  f"(device loop, float32): engine cuda {ms_cuda:.3f} ms (median of 5; "
                  f"{ms_cuda / its:.3f} ms per iteration); engine torch {ms_torch:.1f} ms (one "
                  f"run); speed-up {ms_torch / ms_cuda:.1f}x")

    # the per-member study on d1_plan's launch and on one lane a member
    def study(one_lane=False):
        loop = dg_loop.run_adaptive_dg_per_member
        if not one_lane:
            return loop(sin.f, y0s, (0.0, 2.0), engine="cuda", **kw)
        with mock.patch.object(ds, "d1_plan", lambda b, np_, nq: ds.D1Launch(1, ds.D1_THREADS)):
            return loop(sin.f, y0s, (0.0, 2.0), engine="cuda", **kw)

    turns = in_turns({"d1_plan": study, "one lane a member": lambda: study(True)})
    say("11", f"run_adaptive_dg_per_member B={DG_STUDY['b']} in turns, median of 5 each: on "
              f"d1_plan's launch {statistics.mean(turns['d1_plan']):.3f} ms "
              f"({turns['d1_plan'][0]:.3f} / {turns['d1_plan'][1]:.3f}), on one lane a member "
              f"{statistics.mean(turns['one lane a member']):.3f} ms "
              f"({turns['one lane a member'][0]:.3f} / {turns['one lane a member'][1]:.3f})")
    return out["9(a) libm"]


# ------------------------------------------------------------ hp DG-in-time


def hp_inputs(device, b, k, n_user, seed, uniform=None):
    """y0 ~ U(0.5, 2) from ``default_rng(seed)`` (the driver's and bench.py's
    draw), then per-member partitions of [0, 2] with 2..k live slabs whose
    interior nodes lie on a 2⁻¹⁰ grid (distinct, exact in float32),
    zero-width tails at t = 2, and orders 1..n_user (or ``uniform`` on every
    slab)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y0 = rng.uniform(0.5, 2.0, b)
    t = np.full((b, k + 1), HP_STUDY["t1"])
    ns = np.full((b, k), uniform or 1, np.int64)
    for m, n_act in enumerate(rng.integers(2, k + 1, b)):
        inner = np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024
        t[m, : n_act + 1] = np.concatenate([[0.0], inner, [HP_STUDY["t1"]]])
        if uniform is None:
            ns[m, :n_act] = rng.integers(1, n_user + 1, n_act)
    return (torch.tensor(t, dtype=torch.float32, device=device), torch.tensor(ns, device=device),
            torch.tensor(y0, dtype=torch.float32, device=device))


def hp_kernel(ode, n_user, fo, k, mode, device, g_u=None):
    from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
        dg_adjoint_interp_mixed,
        dg_radau_interp_mixed,
    )
    from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    mops = dg_time_operators_mixed(n_user + fo)
    return hm.make_cuda_dg_estimate_hp_per_member(
        ode, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=n_user, fine_offset=fo,
        newton_iters=HP_STUDY["newton_iters"], adjoint_mode=mode,
        rad=dg_radau_interp_mixed(mops), g_u=g_u, device=device)


def hp_case(label, device, errs, ode="du/dt=sin(u)", n_user=HP_STUDY["n_max"], fo=HP_STUDY["fo"],
            b=HP_STUDY["b"], k=HP_K, seed=HP_STUDY["seed"], mode="solve", uniform=None):
    """One phase-12 comparison: H1 against its plain version on the card."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    times, ns, y0 = hp_inputs(device, b, k, n_user, seed, uniform)
    run = hp_kernel(ode, n_user, fo, k, mode, device)
    got = run(times, ns, y0)
    torch.cuda.synchronize()
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    e, share = hp_shares(got, want, tol)
    tail = times[:, :-1] == HP_STUDY["t1"]  # the trailing zero-width slabs
    assert bool(tail.any()) and bool((got[3][tail] == 0).all()), f"{label}: a tail contributed"
    # every bound is per element: how many elements a zero output would fail
    live = ~tail
    teeth = {name: int((w.abs().amax(dim=-1)[live] > tol[name][..., 0][live]).sum())
             for name, w in zip(("u_c", "u_f", "v"), want)}
    teeth["err"] = int((want[3].abs() > tol["err"]).sum())
    say("12", f"{label}: {ode} n_max_user {n_user} fo {fo} (np_max {run.plan.mops.np_max}) K={k} "
              f"B={b} {mode}, {hm.hp_plan(b, run.plan.mops.np_max, run.plan.mops.rq.shape[0])} | "
              + " ".join(f"{x} {e[x]:.3e} (per-element tol <= {float(tol[x].max()):.3e}, worst "
                         f"{share[x]:.2%} of it)" for x in e)
        + f"; max|err| {float(want[3].abs().max()):.3e}; elements above their bound of "
          f"{int(live.sum())} live: {teeth}; {int(tail.sum())} tail slabs, each contribution "
          f"exactly 0")
    assert max(share.values()) <= 1.0, f"{label}: the hp kernel disagrees"
    assert teeth["err"] > 0, f"{label}: the err bound cannot tell an err of 0 from the plain version's"
    errs["dg_estimate_hp_per_member"] = max(errs["dg_estimate_hp_per_member"], *e.values())
    return run, (times, ns, y0), got, tol


def hp_shares(got, want, tol):
    """Per output (u_c, u_f, v, err): max|kernel − plain| and its worst
    share of hp_kernel_tolerance's per-element bound (a bound of 0 takes
    only an exact 0)."""
    return shares(("u_c", "u_f", "v", "err"), got, want, tol)


def phase12(device, errs):
    """The hp kernel against its plain version on the card, float32, both
    adjoint modes; at uniform orders against D1."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    cases = {}
    for mode in ("solve", "reconstruct"):
        cases["a", mode] = hp_case("(a) bench shape", device, errs, mode=mode)
        cases["b", mode] = hp_case("(b)", device, errs, b=HP_BIG["b"], seed=HP_BIG["seed"],
                                   mode=mode)
        hp_case("(c) np_max 8", device, errs, n_user=5, b=1024, seed=7, mode=mode)
        for ode in ("du/dt=t*sin(u)", "gaussian_mixture"):
            hp_case(f"(d) {ode}", device, errs, ode=ode, b=HP_BIG["b"], seed=8, mode=mode)
    # (e) uniform orders: H1 is D1 at order n on the same Gauss rule
    n_gq = 3 * (HP_STUDY["n_max"] + HP_STUDY["fo"]) + 6
    for n in (1, 2, 3):
        run, (times, ns, y0), got, tol = hp_case(f"(e) uniform order {n}", device, errs,
                                                 seed=10 + n, uniform=n)
        d1 = ds.make_cuda_dg_estimate_ensemble(
            "du/dt=sin(u)", dg_time_operators(n, n_gq), dg_time_operators(n + 1, n_gq), HP_K,
            HP_STUDY["newton_iters"], device=device)(times, y0)
        torch.cuda.synchronize()
        d_err = (got[3] - d1[2]).abs().double()
        e = (float((got[0][..., : n + 1] - d1[0]).abs().max()),
             float((got[2][..., : n + 2] - d1[1]).abs().max()), float(d_err.max()))
        pads = (float(got[0][..., n + 1:].abs().max()), float(got[2][..., n + 2:].abs().max()))
        ok_u = bool(((got[0][..., : n + 1] - d1[0]).abs() <= tol["u_c"]).all())
        ok_v = bool(((got[2][..., : n + 2] - d1[1]).abs() <= tol["v"]).all())
        say("12", f"(e) order {n}: H1 vs D1 (same Gauss rule) u {e[0]:.3e} (per-element tol <= "
                  f"{float(tol['u_c'].max()):.3e}) v {e[1]:.3e} (per-element tol <= "
                  f"{float(tol['v'].max()):.3e}) err {e[2]:.3e} (per-element tol, worst "
                  f"{float((d_err / tol['err'].clamp_min(1e-300)).max()):.2%} of it); padded "
                  f"nodes max |u| {pads[0]:.1e} |v| {pads[1]:.1e}")
        assert ok_u and ok_v and bool((d_err <= tol["err"]).all())
        assert max(pads) == 0
    hp_refusals(cases["a", "solve"])
    return cases


def hp_refusals(case):
    """The hp wrapper on the card refuses what the kernel does not take."""
    import torch

    run, (times, ns, y0), _, _ = case
    for bad, exc in ((lambda: run(times.double(), ns, y0.double()), TypeError),
                     (lambda: run(times, ns, torch.cat([y0, y0])[::2]), ValueError)):
        try:
            bad()  # float64, then a non-contiguous operand
        except exc:
            continue
        raise AssertionError("the hp wrapper took an input it must refuse")
    say("12", "float64 and non-contiguous inputs raise; no plain-version fallback on the card")


def hp_replay(hist, mode, device, errs, g_u=None, key="dg_estimate_hp_per_member"):
    """Every iteration's partitions and orders of a per-member study through
    the plain version (float32, held to H1's per-element bound) and the
    torch engine (float64, decisions only): the p/h decisions of members
    whose top-two |err| margin clears 4x the member's largest bound. ``g_u``
    the study's goal (None: J = ∫u); the worst |d err| goes to ``errs[key]``."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import dg_estimate_mixed
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    sin = odes.get_ode("du/dt=sin(u)")
    plan = hp_kernel(sin, HP_STUDY["n_max"], HP_STUDY["fo"], HP_K, mode, device, g_u).plan
    y32 = np.random.default_rng(HP_STUDY["seed"]).uniform(0.5, 2.0, HP_STUDY["b"]).astype(
        np.float32)
    y0, y64 = (torch.tensor(y32, dtype=d, device=device) for d in (torch.float32, torch.float64))
    out = dict(decided=0, agree=0, decided64=0, agree64=0, err=0.0, share=0.0, tol=0.0)
    for r in hist:
        times = torch.tensor(r.times, dtype=torch.float32, device=device)
        ns = torch.tensor(r.ns, dtype=torch.int64, device=device)
        plain = hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan)
        tol = hm.hp_kernel_tolerance(times, ns, y0, plain, plan)["err"]
        err_k = torch.tensor(r.err, dtype=torch.float32, device=device)
        d_err = (err_k - plain[3]).abs().double()
        assert bool((d_err <= tol).all()), (float(d_err.max()), float(tol.max()))
        out["err"], out["tol"] = max(out["err"], float(d_err.max())), max(out["tol"],
                                                                          float(tol.max()))
        out["share"] = max(out["share"], float((d_err / tol.clamp_min(1e-300)).max()))
        err64 = dg_estimate_mixed(plan.mops, plan.interp, sin.f, times.double(), ns, y64,
                                  fine_offset=HP_STUDY["fo"], adjoint_mode=mode, rad=plan.rad,
                                  f_u=sin.f_u, g_u=plan.functors.g_u,
                                  newton_iters=HP_STUDY["newton_iters"])[3]
        noise = tol.amax(dim=1)
        for tag, (d, a) in (("", dg_decisions(err_k, plain[3], noise)),
                            ("64", dg_decisions(err_k.double(), err64, noise))):
            out["decided" + tag] += d
            out["agree" + tag] += a
    errs[key] = max(errs[key], out["err"])
    assert out["decided"] > 0, "no decision of the study clears the float32 bound"
    assert out["agree"] == out["decided"] and out["agree64"] == out["decided64"], out
    return out


def phase13(device, errs):
    """The hp paths through their entry points."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    b, its = HP_STUDY["b"], HP_STUDY["maxit"] + 1
    launches = None
    for mode in ("solve", "reconstruct"):
        argv = HP_ARGV + ["--per-member", "--device-loop", "--adjoint", mode]
        hm.reset_launch_counts()
        t0 = time.perf_counter()
        hist = dg_adaptive.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = hm.dg_estimate_hp_per_member.launches
        last = hist[-1]
        say("13", f"{'main path ' if launches is None else ''}dg_adaptive {' '.join(argv)}: "
                  f"{len(hist)} iterations, K {hist[0].n_active.max()} -> [{last.n_active.min()}.."
                  f"{last.n_active.max()}], max order {last.ns.max()}, {last.n_refining} of {b} "
                  f"refining, mean |est| {np.abs(hist[0].est_total).mean():.3e} -> "
                  f"{np.abs(last.est_total).mean():.3e}, wall {wall:.3f} s, H1 launches {n_launch}")
        assert n_launch == its and len(hist) == its, (n_launch, len(hist))
        for r in hist:
            assert np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j_coarse))
        if launches is None:
            launches = {"dg_estimate_hp_per_member": n_launch}
        rep = hp_replay(hist, mode, device, errs)
        say("13", f"replay ({mode}) of {len(hist)} iterations through the plain version: max|d err| "
                  f"{rep['err']:.3e} (per-element tol <= {rep['tol']:.3e}, worst "
                  f"{rep['share']:.2%} of it); decisions with a top-two margin > 4x the member's "
                  f"largest err bound: {rep['decided']} of {len(hist) * b} member-iterations, "
                  f"kernel and plain agree on {rep['agree']}; against the float64 torch engine "
                  f"{rep['decided64']} clear it, agreement on {rep['agree64']}")

    hm.reset_launch_counts()
    ens = dg_adaptive.main(HP_ARGV)
    torch.cuda.synchronize()
    say("13", f"dg_adaptive {' '.join(HP_ARGV)} (shared partition, cuda engine): {len(ens)} "
              f"iterations, K {len(ens[0].ns)} -> {len(ens[-1].ns)}, orders "
              f"{ens[-1].ns.min()}..{ens[-1].ns.max()}, mean Adj-W Res {ens[0].est_total:+.4e} -> "
              f"{ens[-1].est_total:+.4e}, H1 launches {hm.dg_estimate_hp_per_member.launches}")
    assert len(ens) == its and hm.dg_estimate_hp_per_member.launches == its
    assert all(np.isfinite(r.est_total) and np.all(np.isfinite(r.u)) for r in ens)

    argv = ["--hp", "p", "--k0", "4", "--order", "1", "--n-max", "4", "--tol", "1e-9"]
    with redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        card = dg_adaptive.main(argv)
        wall = time.perf_counter() - t0
        cpu = dg_adaptive.main(argv + ["--device", "cpu"])
    assert len(card) == len(cpu)
    diff = 0.0
    for a, c in zip(card, cpu):
        assert np.array_equal(a.times, c.times) and np.array_equal(a.ns, c.ns)
        for f in ("u", "v", "err"):
            diff = max(diff, float(np.max(np.abs(getattr(a, f) - getattr(c, f)))))
        for f in ("j_coarse", "j_fine", "est_total"):
            diff = max(diff, abs(getattr(a, f) - getattr(c, f)))
    say("13", f"dg_adaptive {' '.join(argv)} (float64 on the card): {len(card)} iterations, "
              f"orders {card[-1].ns.tolist()}, est {card[0].est_total:.4e} -> "
              f"{card[-1].est_total:.4e}, wall {wall:.2f} s; equal partitions and orders to "
              f"--device cpu, max value difference {diff:.3e} (limit 1e-12)")
    assert diff <= 1e-12 and abs(card[-1].est_total) < 1e-9
    return launches


def dg_hp_bound(times, ns, newton_iters, fo, nq, np_max, adjoint_mode, goal=False, pair=2,
                gu=1):
    """Least time on the card for one H1 call: the larger of bytes (times,
    ns and y0 read once; u_c, u_f, v (B, K, np_max) and err written once)
    over 3.35 TB/s and FP32 operations over 67 TFLOP/s, counted as in
    dg_slab_bound at each LIVE (positive-width) member-element's own orders
    — coarse p = n+1 nodes, fine n+fo+1, adjoint n+2 (its system n+1 nodes
    in the reconstruct mode, plus the Radau lift) — not the padded np_max,
    so the bound does not depend on the padding. A Newton step at p nodes:
    Nq points of 2p² + 5p + 4, the assembly 4p² + 3p, one p×p solve and
    the update. A ``goal`` other than J = ∫u adds g_u at the system's nodes
    and the FMAs of M·g_u. ``pair`` and ``gu`` as in dg_slab_bound."""
    import numpy as np

    t, n = times.double().cpu().numpy(), ns.cpu().numpy()
    b, k = n.shape
    n = n[np.diff(t, axis=1) > 0]
    solve = np.vectorize(solve_ops)

    def march(p):
        return newton_iters * (nq * (2 * p * p + 5 * p + 2 + pair) + 4 * p * p + 4 * p + solve(p))

    pc, pf, pa = n + 1, n + fo + 1, n + 2
    ps = pa if adjoint_mode == "solve" else pc
    adj = (2 * pa * pc + nq * (2 * pc + 2 + pair + 2 * pa + ps + 2 * ps * ps) + 2 * ps * ps
           + 2 * ps + solve(ps) + pa * (2 * pa + 6))
    if adjoint_mode == "reconstruct":
        adj = adj + 2 * pa * pc + 2 * pa * pa
    if goal:
        adj = adj + gu * ps + 2 * ps * ps
    n_ops = float(np.sum(march(pc) + march(pf) + adj))
    n_bytes = 4 * (b * (k + 1) + b * k + b + 3 * b * k * np_max + b * k)
    return bound(n_bytes, n_ops)


def hp_times(device, cases):
    """Phase 14: CUDA events, one warm-up, median of 5, H1 and its plain
    version at 12(a) and 12(b) in each adjoint mode; the B = 512 and 4096
    per-member studies (device loop) with each engine. Returns (kernel ms,
    plain ms, bound) at 12(a) solve for the kernel line."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    out = {}
    for key in (("a", "solve"), ("a", "reconstruct"), ("b", "solve"), ("b", "reconstruct")):
        run, (times, ns, y0), _, _ = cases[key]
        plan = run.plan
        ms = cuda_ms(lambda: run(times, ns, y0), runs=5)
        plain_ms = cuda_ms(lambda: hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan), runs=5)
        b_ms, b_by = dg_hp_bound(times, ns, plan.newton_iters, plan.fine_offset,
                                 plan.mops.rq.shape[0], plan.mops.np_max, plan.adjoint_mode)
        b = y0.shape[0]
        launch = hm.hp_plan(b, plan.mops.np_max, plan.mops.rq.shape[0])
        say("14", f"dg_estimate_hp_per_member 12({key[0]}) {key[1]} B={b} K={HP_K} on "
                  f"{launch.lanes} lanes a member, {launch.threads}-thread CTAs: kernel "
                  f"{ms:.4f} ms = {b * HP_K / (ms / 1e3):.4e} member-elements/s; plain "
                  f"{plain_ms:.3f} ms; kernel speed-up {plain_ms / ms:.1f}x; bound {b_ms:.6f} ms "
                  f"({b_by}), kernel at {b_ms / ms:.2%} of it")
        out[key] = (ms, plain_ms, (b_ms, b_by))

    its = HP_STUDY["maxit"] + 1
    for b, seed in ((HP_STUDY["b"], HP_STUDY["seed"]), (HP_BIG["b"], HP_BIG["seed"])):
        study = hp_study(device, b, seed)
        ms_cuda = cuda_ms(lambda: study("cuda"), runs=5)
        ms_torch = cuda_ms(lambda: study("torch"), runs=1, warmup=0)
        say("14", f"run_adaptive_dg_hp_per_member B={b} k0 {HP_STUDY['k0']} n_max "
                  f"{HP_STUDY['n_max']} maxit {HP_STUDY['maxit']} (device loop, float32): engine "
                  f"cuda {ms_cuda:.3f} ms (median of 5; {ms_cuda / its:.3f} ms per iteration); "
                  f"engine torch {ms_torch:.1f} ms (one run); speed-up {ms_torch / ms_cuda:.1f}x")
        if b == HP_STUDY["b"]:
            study_trace(lambda: study("cuda"), "hp_kernel")
    return out["a", "solve"]


def hp_study(device, b, seed):
    """``study(engine)``: bench.py's per-member hp study (device loop,
    float32) at B members, y0 ~ U(0.5, 2) from ``default_rng(seed)``."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop

    sin = odes.get_ode("du/dt=sin(u)")
    kw = dict(f_u=sin.f_u, k0=HP_STUDY["k0"], n0=1, n_max=HP_STUDY["n_max"], mode="hp", tol=0.0,
              maxit=HP_STUDY["maxit"], newton_iters=HP_STUDY["newton_iters"], ode=sin,
              device_loop=True, dtype=torch.float32, device=device)
    y0s = np.random.default_rng(seed).uniform(0.5, 2.0, b).astype(np.float32)

    def study(engine):
        hp_loop.run_adaptive_dg_hp_per_member(sin.f, y0s, (0.0, HP_STUDY["t1"]), engine=engine,
                                              **kw)

    return study


def study_trace(run, kernel, phase="14", also=()):
    """One warm run of ``run`` under torch.profiler: the wall under the
    profiler, the device time summed over the kernels it ran, the device's
    busy share of the wall, ``kernel``'s (and each of ``also``'s) share of
    the device time, and the host's stream synchronisations and copies.
    Returns {name: (device ms, launches recorded)} of those kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    total = sum(dev_ms(e) for e in events)
    shares, seen = [], {}
    for name in (kernel, *also):
        mine = sum(dev_ms(e) for e in events if name in e.key)
        n_mine = sum(e.count for e in events if name in e.key)
        seen[name] = (mine, n_mine)
        shares.append(f"{name} {mine:.3f} ms in {n_mine} launches "
                      f"({mine / max(total, 1e-12):.1%} of the device time)")
    calls = {k: sum(e.count for e in events if e.key == k)
             for k in ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")}
    say(phase, f"torch.profiler over one warm run: wall {wall:.3f} ms under the profiler, device "
              f"busy {total:.3f} ms ({total / wall:.1%} of the wall, idle {1 - total / wall:.1%}); "
              f"{'; '.join(shares)}; host calls {calls}")
    return seen


# ------------------------------------------------------------------ NN strand


def nn_t1_inputs(device, s=None, f=None, b=None, seed=None, perturb=0.0):
    """bench.py's T1 inputs: one ResBlockSimple(F) draw stacked S times
    (``perturb`` adds per-step noise), dt 0.1, ICs ~ U(0.5, 2), targets the
    exact sin u solution at t = 1."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    s, f, b = s or NN_T1["s"], f or NN_T1["f"], b or NN_T1["b"]
    seed = NN_T1["seed"] if seed is None else seed
    gen = torch.Generator().manual_seed(NN_T1["init_seed"])
    one = ResBlockSimple(f).init_params(gen)
    stacked = {k: torch.stack([v] * s) + perturb * torch.randn((s,) + v.shape, generator=gen)
               for k, v in one.items()}
    u0 = torch.tensor(np.random.default_rng(seed).uniform(0.5, 2.0, b), dtype=torch.float32,
                      device=device)
    sin = odes.get_ode("du/dt=sin(u)")
    return (tf.pack_params(stacked, s, f).to(device),
            torch.full((s,), NN_T1["dt"], dtype=torch.float32, device=device), u0,
            sin.exact_fwd(1.0, u0).to(torch.float32))


def leaf_teeth(label, leaves):
    """Assert, for each (name, reference, bound) leaf, that most of its
    entries with a nonzero bound have |reference| above it (a wrong or zero
    leaf cannot pass). Returns the smallest such share over the leaves."""
    least = 1.0
    for name, ref, bnd in leaves:
        live = int((bnd > 0).sum())
        above = int((ref.abs() > bnd).sum())
        assert 2 * above > live > 0, (f"{label}: {above} of {live} entries of {name} above "
                                      f"their bound: it cannot tell a wrong gradient")
        least = min(least, above / live)
    return least


def t1_case(label, device, errs, packed, dt, u0, tg, phase="15", **kw):
    """One T1 comparison: T1 twice (bit-identical), against its plain
    version in float64, each gradient entry within its own float32 bound,
    most entries of each leaf above it, inactive and zero-dt entries exactly
    0. The recorded error is at the wrapper's scale (divided by Σw when
    weighted)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    inv_b = 1.0 if kw.get("weights") is not None else 1.0 / u0.shape[0]
    loss, g = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
    loss2, g2 = tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(loss, loss2), f"{label}: a repeat call differs"
    d64 = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
           for k, v in kw.items()}
    l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), dt.double(), u0.double(),
                                            tg.double(), inv_b=inv_b, **d64)
    tol = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b, **kw)
    d = (g.double() - g64).abs()
    share = float((d / tol["grads"].clamp_min(1e-300)).max())
    teeth = int((g64.abs() > tol["grads"]).sum())
    zero = tol["grads"] == 0
    s_steps, f = packed.shape[1:]
    say(phase, f"{label}: S={s_steps} F={f} B={u0.shape[0]} | loss {float(loss):.6e} (float64 "
               f"{float(l64):.6e}, tol {tol['loss']:.2e}); grads max|d| {float(d.max()):.3e}, "
               f"worst {share:.2%} of its entry's bound (bounds {float(tol['grads'].max()):.2e} "
               f"max); {teeth} of {g.numel()} entries above their bound; {int(zero.sum())} "
               f"entries with bound 0 (a neuron no member activates, inactive or zero-dt) "
               f"exactly 0; repeat call bit-identical")
    assert abs(float(loss) - float(l64)) <= tol["loss"], f"{label}: loss"
    assert bool((d <= tol["grads"]).all()), f"{label}: T1 disagrees with its plain version"
    least = leaf_teeth(label, [(name, g64[i], tol["grads"][i])
                               for i, name in enumerate(("bias", "weights1", "weights2"))])
    say(phase, f"{label}: each leaf has at least {least:.1%} of its nonzero-bound entries above "
               f"their bound")
    assert bool((g[zero] == 0).all()), f"{label}: an inactive or zero-dt entry is not 0"
    live = 1.0 if kw.get("weights") is None else float(kw["weights"].sum())
    errs["resblock_epoch_grad"] = max(errs["resblock_epoch_grad"], float(d.max()) / live,
                                      abs(float(loss) - float(l64)) / live)
    return loss, g


def phase15(device, errs):
    """T1 against its plain version on the card, cases (a)-(f)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.train.losses import mixed_ramp_weight

    packed, dt, u0, tr = nn_t1_inputs(device)
    _, g_a = t1_case("(a) bench shape", device, errs, packed, dt, u0, tr)
    s, f = NN_T1["s"], NN_T1["f"]
    na = torch.tensor([500, 17, 250, 499, 1, 100, 333, 64, 500, 7][:s], dtype=torch.int32,
                      device=device).clamp(max=f)
    pk_b, *_ = nn_t1_inputs(device, perturb=0.05)
    t1_case("(b) masked, capacity 500", device, errs, pk_b, dt, u0, tr, n_active=na)
    nodes = torch.arange(s + 1, device=device, dtype=torch.float64) * NN_T1["dt"]
    from adjoint_ode_adaptivity_tpu_torch import odes

    traj = odes.get_ode("du/dt=sin(u)").exact_fwd(nodes[:, None], u0.double()[None, :])
    t1_case("(c) mixed loss, ramp 10^-1", device, errs, pk_b, dt, u0,
            traj.to(torch.float32).contiguous(), mixed=True, ramp_weight=mixed_ramp_weight(29))
    w = torch.tensor(np.random.default_rng(12).uniform(size=u0.shape[0]) < 0.7,
                     dtype=torch.float32, device=device)
    t1_case("(d) 0/1 member weights", device, errs, pk_b, dt, u0, tr, weights=w)
    pad = 4
    pk_e = torch.cat([packed, packed[:, :1].repeat(1, pad, 1)], dim=1).contiguous()
    dt_e = torch.cat([dt, torch.zeros(pad, device=device)])
    _, g_e = t1_case("(e) 4 zero-dt padded steps", device, errs, pk_e, dt_e, u0, tr)
    assert torch.equal(g_e[:, :s], g_a) and not g_e[:, s:].any(), "(e): padding changed T1"
    say("15", "(e) the live steps' gradients are bit-identical to (a)'s, the padded ones 0")
    pk_f, dt_f, u0_f, tr_f = nn_t1_inputs(device, s=48 if f >= 100 else 2 * s, perturb=0.05)
    t1_case("(f) S=48", device, errs, pk_f, dt_f * 0.25, u0_f, tr_f)
    return packed, dt, u0, tr


def nn_t2_inputs(device, s_steps):
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.models import ResNetBlock

    sizes, b = NN_T2["sizes"], NN_T2["b"]
    params = ResNetBlock(sizes).init_params(torch.Generator().manual_seed(NN_T2["init_seed"]),
                                            device=device)
    u0 = torch.tensor(np.random.default_rng(NN_T2["seed"]).uniform(0.5, 2.0, b),
                      dtype=torch.float32, device=device)
    tr = odes.get_ode("du/dt=sin(u)").exact_fwd(1.0, u0).to(torch.float32)
    return params, torch.full((s_steps,), 1.0 / s_steps, dtype=torch.float32, device=device), u0, tr


def t2_case(label, device, errs, params, dt, u0, tr, phase="16", plan=None):
    """One T2 comparison: T2 twice (bit-identical; through the wrapper, or
    on ``plan``), against its plain version in float64, each gradient entry
    within its own calibrated float32 bound at the plan's (BM, C) (dead and
    zero-dt entries, bound 0, exactly), most entries of each leaf above
    it."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td

    sizes = NN_T2["sizes"]
    theta = td.pack_dense(params, sizes, device)
    if plan is None:
        loss, flat = td.dense_epoch_grad(theta, sizes, dt, u0, tr)
        loss2, flat2 = td.dense_epoch_grad(theta, sizes, dt, u0, tr)
        plan = td.dense_plan(sizes, u0.shape[0], td._sm_count(u0.device))
    else:
        loss, flat = td._t2_launch(theta, sizes, dt, u0, tr, plan)
        loss2, flat2 = td._t2_launch(theta, sizes, dt, u0, tr, plan)
    torch.cuda.synchronize()
    assert torch.equal(flat, flat2) and torch.equal(loss, loss2), f"{label}: a repeat call differs"
    got = td.unpack_dense(flat, sizes)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
    tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, plan.block_members, plan.cluster)
    worst, share, teeth, live, n = 0.0, 0.0, 0, 0, 0
    for k in g64:
        for q in g64[k]:
            bnd = tol["grads"][k][q]
            d = (got[k][q].double() - g64[k][q]).abs()
            assert bool((d <= bnd).all()), f"{label}: T2 disagrees with its plain version at {k}/{q}"
            worst = max(worst, float(d.max()))
            share = max(share, float((d / bnd.clamp_min(1e-300)).max()))
            teeth += int((g64[k][q].abs() > bnd).sum())
            live += int((bnd > 0).sum())
            n += d.numel()
    least = leaf_teeth(label, [(f"{k}/{q}", g64[k][q], tol["grads"][k][q])
                               for k in g64 for q in g64[k]])
    say(phase, f"{label}: sizes {sizes} S={dt.shape[0]} B={u0.shape[0]} plan (BM, C) = "
               f"({plan.block_members}, {plan.cluster}) | loss {float(loss):.6e} "
               f"(float64 {float(l64):.6e}, tol {tol['loss']:.2e}); grads max|d| {worst:.3e}, "
               f"worst {share:.2%} of its entry's bound (rho {tol['rho']:.2e}); {teeth} of "
               f"{live} nonzero-bound entries above their bound, each leaf at least "
               f"{least:.1%}; {n - live} entries with bound 0 exactly 0; repeat call "
               f"bit-identical")
    assert abs(float(loss) - float(l64)) <= tol["loss"], f"{label}: loss"
    errs["dense_epoch_grad"] = max(errs["dense_epoch_grad"], worst, abs(float(loss) - float(l64)))
    return got


def phase16(device, errs):
    """T2 against its plain version on the card at bench.py's shapes."""
    import torch

    for s_steps in NN_T2["steps"]:
        t2_case(f"S={s_steps}", device, errs, *nn_t2_inputs(device, s_steps))
    params, dt, u0, tr = nn_t2_inputs(device, 10)
    dt_z = torch.cat([dt, torch.zeros(3, device=device)])
    got_z = t2_case("S=10 + 3 zero-dt steps", device, errs, params, dt_z, u0, tr)
    got = t2_case("S=10 again (against the padded run)", device, errs, params, dt, u0, tr)
    for k in got:
        for q in got[k]:
            assert torch.equal(got[k][q], got_z[k][q]), "zero-dt steps changed T2"
    say("16", "the zero-dt steps leave T2's gradients bit-identical")


def nn_main(argv):
    """``train_resnet_ode.main(argv)`` with its output captured; returns
    (state, times, printed lines, JSONL records, recorded signals, wall s)."""
    import io
    from contextlib import redirect_stdout

    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import train_resnet_ode as drv

    out_dir = ROOT / "build" / "nn_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "metrics.jsonl"
    path.unlink(missing_ok=True)
    signals, orig = [], drv.ensemble_refinement_signal

    def record(*a, **k):
        r = orig(*a, **k)
        signals.append(r.double().cpu())
        return r

    drv.ensemble_refinement_signal = record
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            state, times = drv.main(argv + ["--jsonl", str(path), "--quiet"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        drv.ensemble_refinement_signal = orig
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    return state, times, buf.getvalue().splitlines(), recs, signals, wall


def replay_check(label, recs, recs_t, a, b, epochs):
    """The cuda run's first ``epochs`` epochs against the torch engine's
    replay: per-epoch loss and error within NN_DRIFT (relative), the
    refinement signals likewise, and the same insertion wherever the
    signal's top-two margin clears twice the drift."""
    import math

    import torch

    drift = max(abs(x["Loss"] - y["Loss"]) / abs(y["Loss"]) for x, y in zip(recs, recs_t))
    drift_e = max(abs(x["Error"] - y["Error"]) / abs(y["Error"]) for x, y in zip(recs, recs_t))
    top = torch.sort(b, descending=True).values
    margin = float(top[0] - top[1]) if len(top) > 1 else math.inf
    decided = margin > 2 * NN_DRIFT * float(top[0])
    say("17", f"{label}: over {epochs} epochs the loss drifts by at most {drift:.3e} relative, "
              f"the error by {drift_e:.3e} (limit {NN_DRIFT}); signals {a.tolist()} vs "
              f"{b.tolist()}, top-two margin {margin:.3e} -> insertion at "
              f"{int(torch.argmax(a)) + 1} and {int(torch.argmax(b)) + 1}"
              f"{' (decided)' if decided else ' (inside the drift)'}")
    assert len(recs_t) == epochs and drift <= NN_DRIFT and drift_e <= NN_DRIFT, label
    assert float((a - b).abs().max()) <= 2 * NN_DRIFT * float(b.abs().max()), label
    assert not decided or int(torch.argmax(a)) == int(torch.argmax(b)), f"{label}: insertions differ"


def phase17(device, errs):
    """The NN path through its entry point, and every T1 variant and T2
    through the driver."""
    import math

    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import train_resnet_ode as drv
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf
    from adjoint_ode_adaptivity_tpu_torch.train.data import make_batches, rk4_truth
    from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

    tf.reset_launch_counts()
    td.reset_launch_counts()
    state, times, lines, recs, sig, wall = nn_main(NN_ARGV)
    n_t1, n_t2 = tf.resblock_epoch_grad.launches, td.dense_epoch_grad.launches
    args = drv.build_parser().parse_args(NN_ARGV)
    epochs, its = args.epochs, args.maxit + 1
    say("17", f"main path train_resnet_ode {' '.join(NN_ARGV)}: {len(recs)} epochs, loss "
              f"{recs[0]['Loss']:.4e} -> {recs[-1]['Loss']:.4e}, error {recs[0]['Error']:.4e} -> "
              f"{recs[-1]['Error']:.4e}; " + "; ".join(x for x in lines if x.startswith("outer"))
        + f"; wall {wall:.2f} s ({len(recs) / wall:.1f} epochs/s with signals and logging); "
          f"T1 launches {n_t1}, T2 launches {n_t2}")
    assert n_t1 == epochs * its and n_t2 == 0 and len(recs) == epochs * its
    assert all(math.isfinite(r["Loss"]) and math.isfinite(r["Error"]) for r in recs)
    assert len(times) == args.n_steps + its + 1
    assert state.params["bias"].shape[0] == len(times) - 1
    launches = {"resblock_epoch_grad": n_t1}

    # the first outer iteration again through the torch engine on the card
    tf.reset_launch_counts()
    _, _, lines_t, recs_t, sig_t, wall_t = nn_main(NN_ARGV[:-1] + ["0", "--train-engine", "torch"])
    assert tf.resblock_epoch_grad.launches == 0 and len(recs_t) == epochs
    p1, u0_train, _ = drv.initial_draws(args, device)
    tr = rk4_truth(drv._ode(args).f, u0_train, (0.0, args.t1), n_sub=256)
    stacked = tree_map(lambda x: torch.stack([x] * args.n_steps), p1)
    packed = tf.pack_params(stacked, args.n_steps, args.width)
    dt = torch.diff(torch.tensor(np.linspace(0.0, args.t1, args.n_steps + 1), dtype=torch.float32,
                                 device=device))
    tol0 = tf.resblock_kernel_tolerance(packed, dt, u0_train, tr, inv_b=1.0 / u0_train.shape[0])
    d0 = abs(recs[0]["Loss"] - recs_t[0]["Loss"])
    say("17", f"replay of outer iteration 0 with --train-engine torch ({wall_t:.2f} s): epoch-0 "
              f"loss differs by {d0:.3e} (T1's bound {tol0['loss']:.3e})")
    assert d0 <= 2 * tol0["loss"]
    replay_check("variable_params", recs, recs_t, sig[0], sig_t[0], epochs)

    # T1 at the main path's own shapes: its first call (S=2, the initial
    # draws) and the last depth it trained at (S=5: the trained parameters
    # of the final net's first five steps, with their dt)
    t1_case("main path's first call", device, errs, packed, dt, u0_train, tr, phase="17")
    n_last = len(times) - 2
    p_last = tf.pack_params(tree_map(lambda x: x[:n_last].contiguous(), state.params), n_last,
                            args.width)
    t1_case(f"main path's trained first {n_last} steps", device, errs, p_last,
            torch.diff(times)[:n_last].to(torch.float32).contiguous(), u0_train, tr, phase="17")

    argv_r = NN_REC_ARGV
    rec = drv.build_parser().parse_args(argv_r)
    td.reset_launch_counts()
    tf.reset_launch_counts()
    _, times_r, lines_r, recs_r, sig_r, wall_r = nn_main(argv_r)
    n_t2 = td.dense_epoch_grad.launches
    n_batch = rec.n_train // max(8, rec.n_train // 16)
    say("17", f"train_resnet_ode {' '.join(argv_r)}: {len(recs_r)} epochs of {n_batch} "
              f"minibatches (B={max(8, rec.n_train // 16)}), loss {recs_r[0]['Loss']:.4e} -> {recs_r[-1]['Loss']:.4e}; "
              + "; ".join(x for x in lines_r if x.startswith("outer"))
              + f"; wall {wall_r:.2f} s; T2 launches {n_t2}, T1 {tf.resblock_epoch_grad.launches}")
    assert n_t2 == n_batch * rec.epochs * (rec.maxit + 1)
    assert tf.resblock_epoch_grad.launches == 0 and len(recs_r) == rec.epochs * (rec.maxit + 1)
    assert all(math.isfinite(r["Loss"]) for r in recs_r) and len(times_r) == rec.n_steps + rec.maxit + 2
    launches["dense_epoch_grad"] = n_t2

    # T2 on the recurrent run's first minibatch, and its first outer
    # iteration again through the torch engine
    assert tuple(drv.hidden_sizes(rec)) == NN_T2["sizes"]
    p1_r, u0_r, _ = drv.initial_draws(rec, device)
    tr_r = rk4_truth(drv._ode(rec).f, u0_r, (0.0, rec.t1), n_sub=256)
    batch = max(8, rec.n_train // 16)
    u0_b, tr_b = make_batches(u0_r, tr_r, batch, perm=drv.torch_draws().permutation(0, rec.n_train))
    dt_r = torch.diff(torch.tensor(np.linspace(0.0, rec.t1, rec.n_steps + 1), dtype=torch.float32,
                                   device=device))
    t2_case("recurrent run's first minibatch", device, errs, p1_r, dt_r, u0_b[0].contiguous(),
            tr_b[0].contiguous(), phase="17")
    td.reset_launch_counts()
    _, _, _, recs_rt, sig_rt, wall_rt = nn_main(argv_r[:-1] + ["0", "--train-engine", "torch"])
    assert td.dense_epoch_grad.launches == 0 and len(recs_rt) == rec.epochs
    say("17", f"replay of the recurrent run's outer iteration 0 with --train-engine torch "
              f"({wall_rt:.2f} s)")
    replay_check("recurrent", recs_r, recs_rt, sig_r[0], sig_rt[0], rec.epochs)

    for method, extra in (("width", ["--depth-rel-tol", "0"]), ("new_loss", []),
                          ("detect", [])):
        argv = ["--method", method] + NN_VARIANT_ARGV + extra
        tf.reset_launch_counts()
        _, times_m, lines_m, recs_m, _, wall_m = nn_main(argv)
        n1 = tf.resblock_epoch_grad.launches
        say("17", f"train_resnet_ode {' '.join(argv)}: {len(recs_m)} epochs, loss "
                  f"{recs_m[0]['Loss']:.4e} -> {recs_m[-1]['Loss']:.4e}; "
                  + "; ".join(x for x in lines_m if x.startswith("outer"))
                  + f"; wall {wall_m:.2f} s; T1 launches {n1}")
        assert n1 == len(recs_m) > 0 and all(math.isfinite(r["Loss"]) for r in recs_m)
    return launches


def t1_bound(s_steps, f, b, active=None):
    """Least time for one T1 call: bytes (the parameters, dt, ICs and targets
    read once, the gradients and loss written once) over 3.35 TB/s, against
    the FP32 operations the function needs per member, step and active
    neuron (an FMA counts 2): 5 in the forward (sub, mul, max, FMA), 3 to
    recompute d, s and the relu test once in the backward, and 8 for ds and
    the updates of ∂w2, ∂w1, ∂b and the cotangent. The kernel recomputes
    d, s and the test a second time (its gradient pass); that is not
    counted."""
    active = s_steps * f if active is None else active
    n_bytes = 4 * (3 * s_steps * f * 2 + s_steps + 2 * b + 1)
    n_ops = 16 * b * active
    return (*bound(n_bytes, n_ops), n_ops)


def t2_bound(s_steps, sizes, b):
    """Least time for one T2 call: its inputs and gradients once, against
    its FP32 operations per member and step: 8·Σ H_{l−1}H_l for the four
    hidden products (forward, recompute, ∂W, ∂a) plus ~12·H_1 + 14·H_L
    for the scalar layers, the relus and the reductions."""
    hh = sum(a * c for a, c in zip(sizes[:-1], sizes[1:]))
    n_params = 2 * sizes[0] + hh + sum(sizes[1:]) + sizes[-1] + 1
    n_bytes = 4 * (2 * n_params + hh + s_steps + 2 * b + 1)
    n_ops = b * s_steps * (8 * hh + 12 * sizes[0] + 14 * sizes[-1])
    return (*bound(n_bytes, n_ops), n_ops)


def epoch_loop(device, epochs=20):
    """The main path's steady state under torch.profiler: ``epochs`` epochs
    of what the driver does per epoch at its first outer iteration (the
    cuda train step, T1 + Adam; the test-set evaluation; the two host
    reads that logging makes), at the main path's shapes."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import train_resnet_ode as drv
    from adjoint_ode_adaptivity_tpu_torch.train import loop
    from adjoint_ode_adaptivity_tpu_torch.train.data import rk4_truth
    from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

    args = drv.build_parser().parse_args(NN_ARGV)
    p1, u0, u0_test = drv.initial_draws(args, device)
    ode = drv._ode(args)
    tr, tr_test = (rk4_truth(ode.f, x, (0.0, args.t1), n_sub=256) for x in (u0, u0_test))
    dt = torch.full((args.n_steps,), args.t1 / args.n_steps, device=device)
    net = drv.make_net(args, args.width)
    tx = loop.Adam(args.lr)
    step = loop.make_per_step_train_step_fused(tx, args.n_steps, args.width, device=device)
    state = [loop.create_train_state(tree_map(lambda x: torch.stack([x] * args.n_steps), p1), tx)]

    def run():
        for _ in range(epochs):
            state[0], loss = step(state[0], dt, u0, tr)
            err = loop.evaluate(net, state[0].params, dt, u0_test, tr_test)
            float(loss), float(err)

    study_trace(run, "resblock", phase="18")


def nn_times(device, t1_inputs):
    """Phase 18: CUDA-event times (one warm-up, median of 5) of T1 and T2
    and their float32 plain versions at 15(a) and 16; epochs/s of one full
    train step (kernel + Adam, and autograd + Adam); the hidden-chain GEMMs
    of one T2 call through torch.matmul in IEEE FP32 (a yardstick only)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple, ResNetBlock
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf
    from adjoint_ode_adaptivity_tpu_torch.train import loop

    packed, dt, u0, tr = t1_inputs
    s, f, b = NN_T1["s"], NN_T1["f"], NN_T1["b"]
    inv_b = 1.0 / b
    ms1 = cuda_ms(lambda: tf.resblock_epoch_grad(packed, dt, u0, tr, inv_b=inv_b), runs=5)
    pms1 = cuda_ms(lambda: tf.resblock_epoch_grad_plain(packed, dt, u0, tr, inv_b=inv_b), runs=5)
    b1 = t1_bound(s, f, b)
    params = tf.unpack_grads(packed, s, f)
    ptx = loop.Adam(1e-3)
    steps = {"cuda": loop.make_per_step_train_step_fused(ptx, s, f, device=device),
             "torch": loop.make_per_step_train_step(ResBlockSimple(f), ptx)}
    rate1 = {}
    for eng, step in steps.items():
        st = loop.create_train_state(params, ptx)
        rate1[eng] = 1e3 / cuda_ms(lambda: step(st, dt, u0, tr), runs=5)
    epoch_loop(device)
    say("18", f"resblock_epoch_grad 15(a) S={s} F={f} B={b}: kernel {ms1:.4f} ms; plain "
              f"{pms1:.3f} ms; speed-up {pms1 / ms1:.1f}x; bound {b1[0]:.5f} ms ({b1[1]}), "
              f"kernel at {b1[0] / ms1:.2%} of it; train step (+ Adam) {rate1['cuda']:.1f} "
              f"epochs/s with the cuda engine, {rate1['torch']:.1f} with torch")
    out = {"resblock_epoch_grad": (ms1, pms1, b1)}
    sizes = NN_T2["sizes"]
    for s2 in NN_T2["steps"]:
        p2, dt2, u2, tr2 = nn_t2_inputs(device, s2)
        theta = td.pack_dense(p2, sizes, device)
        ms2 = cuda_ms(lambda: td.dense_epoch_grad(theta, sizes, dt2, u2, tr2), runs=5)
        pms2 = cuda_ms(lambda: td.dense_epoch_grad_plain(p2, sizes, dt2, u2, tr2), runs=3)
        b2 = t2_bound(s2, sizes, u2.shape[0])
        a = torch.rand((u2.shape[0], sizes[0]), device=device)
        w = torch.rand(sizes, device=device)
        dz = torch.rand((u2.shape[0], sizes[1]), device=device)

        def gemms():
            for _ in range(s2):
                a @ w, a @ w, a.T @ dz, dz @ w.T  # forward, recompute, ∂W, ∂a

        gms = cuda_ms(gemms, runs=5)
        st_rate = {}
        for eng in ("cuda", "torch"):
            step = (loop.make_shared_train_step_fused(ptx, dt2, sizes, device=device)
                    if eng == "cuda" else loop.make_shared_train_step(ResNetBlock(sizes), ptx, dt2))
            st = loop.create_train_state(p2, ptx)
            st_rate[eng] = 1e3 / cuda_ms(lambda: step(st, u2, tr2), runs=3)
        say("18", f"dense_epoch_grad {sizes} S={s2} B={u2.shape[0]}: kernel {ms2:.3f} ms "
                  f"({b2[2] / (ms2 / 1e3) / 1e12:.2f} TFLOP/s of its FP32 operations); plain "
                  f"{pms2:.3f} ms; bound {b2[0]:.4f} ms ({b2[1]}), kernel at {b2[0] / ms2:.2%} of "
                  f"it; the same hidden-chain GEMMs through torch.matmul (FP32, TF32 off) "
                  f"{gms:.3f} ms; train step (+ Adam) {st_rate['cuda']:.2f} epochs/s cuda, "
                  f"{st_rate['torch']:.2f} torch")
        if s2 == NN_T2["steps"][0]:
            out["dense_epoch_grad"] = (ms2, pms2, b2)
    # T2 at its path's own shape: the recurrent driver (NN_REC_ARGV) trains
    # minibatches of n_train/16 = 512 members at its starting depth of 2 steps
    p2, dt2, u2, tr2 = nn_t2_inputs(device, 2)
    theta = td.pack_dense(p2, sizes, device)
    u5, tr5 = u2[:512].contiguous(), tr2[:512].contiguous()
    ms5 = cuda_ms(lambda: td.dense_epoch_grad(theta, sizes, dt2, u5, tr5), runs=5)
    b5 = t2_bound(2, sizes, 512)
    say("18", f"dense_epoch_grad {sizes} S=2 B=512 (the recurrent driver's minibatch and "
              f"starting depth): kernel {ms5:.4f} ms; bound {b5[0]:.5f} ms ({b5[1]}), kernel at "
              f"{b5[0] / ms5:.2%} of it")
    return out


# ------------------------------------------------------------ Burgers strand


def burgers_ics(disc, b, device, dtype):
    """bench.py:435-441's batched ICs (0.5 + 0.05·j)·sin x, (Np, B, K)."""
    import numpy as np
    import torch

    u0 = np.stack([(0.5 + 0.05 * j) * np.sin(disc.x) for j in range(b)], axis=1)
    return torch.tensor(u0, dtype=dtype, device=device)


def b1_double(label, u0, n_steps, tab, errs, phase="19", key="burgers_march"):
    """B1 against its plain version in float64, each entry within
    test_pallas.py:629's 1e-12·|plain| + 1e-13 (the same tables, another
    order of operations). Returns the plain version's output."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    got = cb.burgers_march(u0, n_steps, tab)
    want = cb.burgers_march_plain(u0, n_steps, tab)
    d = (got - want).abs()
    bound = 1e-12 * want.abs() + 1e-13
    worst, above = float((d / bound).max()), int((d > bound).sum())
    say(phase, f"{label} float64: max|kernel - plain| {float(d.max()):.3e}, worst entry at "
              f"{worst:.3%} of its bound (1e-12·|plain| + 1e-13), {above} of {d.numel()} "
              f"entries above")
    assert bool(torch.isfinite(got).all()) and above == 0, f"{label}: B1 disagrees in float64"
    errs[key] = max(errs[key], float(d.max()))
    return got


def spread(cells, reach=10):
    """Each (B, K) entry's sum over the elements within ``reach`` of it
    (periodic): how far a changed cell reaches in one step (2 elements a
    stage, through the flux and the limiter's neighbour averages)."""
    import torch

    ext = torch.cat([cells[:, -reach:], cells, cells[:, :reach]], dim=1)
    width = 2 * reach + 1
    return width * torch.nn.functional.avg_pool1d(ext[:, None], width, stride=1)[:, 0]


def b1_lockstep(label, u0, n_steps, tab, errs, phase="19", key="burgers_march"):
    """B1 held to its plain version step by step: every step, both start
    from the plain version's state. Each entry of the kernel's step must lie
    within the step's roundoff — float64: 1e-12·|plain| + 1e-13; float32:
    5·(Np + 2)·ε₃₂·max|u0| (each of the 5 stages rounds the update and, in a
    limited cell, the Np-term cell average and the limited value) — plus,
    within 10 elements of a cell whose ΠN margin in that step lies within
    8·ε·max|u0| of ε₀ (so that roundoff may decide it either way), twice
    the sum of those cells' limiting changes |limited − v| (a decision taken
    the other way moves its cell by that change, and the later stages of
    the step carry it to the neighbours at a CFL fraction a stage). The
    troubled-cell test at ε₀ = 1e-8 sits below float32 roundoff near
    extrema, so float32 has such cells.
    Returns the plain version's final state and its summed time (CUDA
    events, ms)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    f64 = u0.dtype == torch.float64
    eps = 2.0**-52 if f64 else EPS32
    scale = float(u0.abs().max())
    band = 8 * eps * scale
    step_tol = 5 * (tab.np_ + 2) * eps * scale
    u, worst, above, n_near, allow, plain_ms = u0, 0.0, 0, 0, 0.0, 0.0
    for _ in range(n_steps):
        got = cb.burgers_march(u, 1, tab)
        near = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)

        def observe(v, limited, margin, near=near):
            if tab.limiter == "n":
                change = (limited - v).abs().amax(dim=0)
                hit = (margin - cb.EPS0).abs() <= band
                torch.maximum(near, torch.where(hit, change, torch.zeros_like(change)), out=near)

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = cb.burgers_march_plain(u, 1, tab, observe)
        end.record()
        bound = (1e-12 * want.abs() + 1e-13 if f64 else step_tol) + 2 * spread(near)
        d = (got - want).abs()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        worst = max(worst, float((d / bound).max()))
        above += int((d > bound).sum())
        n_near += int((near > 0).sum())
        allow = max(allow, float(near.max()))
        errs[key] = max(errs[key], float(d.max()))
        u = want
    say(phase, f"{label} {'float64' if f64 else 'float32'} step by step ({n_steps} steps): worst "
              f"entry at {worst:.3%} of its bound (roundoff "
              f"{'1e-12·|plain| + 1e-13' if f64 else f'{step_tol:.3e}'} per step), {above} "
              f"entries above; {n_near} cell-steps with ΠN's margin within {band:.1e} of ε₀, "
              f"largest limiting change there {allow:.3e}")
    assert above == 0 and bool(torch.isfinite(u).all()), f"{label}: B1 disagrees step by step"
    return u, plain_ms


def b1_free(label, got, want, n_steps, tab, u0, errs):
    """The free-running kernel against the free-running plain version in
    float32: each entry within n_steps times the per-step roundoff."""
    d = float((got - want).abs().max())
    bound = n_steps * 5 * (tab.np_ + 2) * EPS32 * float(u0.abs().max())
    say("19", f"{label} float32 free-running: max|kernel - plain| {d:.3e} (bound {bound:.3e})")
    assert d <= bound, f"{label}: free-running B1 leaves its plain version"
    errs["burgers_march"] = max(errs["burgers_march"], d)


def burgers_props(label, u, u0, disc, n_steps, eps, phase="20"):
    """After the shock: finite, within the initial range up to 5e-2
    (tests/test_burgers.py's allowance), and Σ cell averages·h conserved
    to roundoff: each stage rounds every node to ε/2 of max|u|, so the total
    moves by at most 5·n_steps·(ε/2)·max|u|·(b − a)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.operators import mass_matrix

    w = torch.tensor(np.sum(mass_matrix(disc.v), axis=0)[:, None] * disc.jac, dtype=torch.float64,
                     device=u.device)
    total0, total = float(torch.sum(w * u0.double())), float(torch.sum(w * u.double()))
    cons = 5 * n_steps * eps / 2 * float(u0.abs().max()) * 2 * np.pi
    lo, hi = float(u0.min()) - 5e-2, float(u0.max()) + 5e-2
    say(phase, f"{label}: finite {bool(torch.isfinite(u).all())}, range [{float(u.min()):+.4f}, "
              f"{float(u.max()):+.4f}] within [{lo:+.4f}, {hi:+.4f}], Σ avg·h {total:+.9f} vs "
              f"{total0:+.9f} (drift {abs(total - total0):.3e}, bound {cons:.3e})")
    assert bool(torch.isfinite(u).all()) and lo <= float(u.min()) and float(u.max()) <= hi
    assert abs(total - total0) <= cons, f"{label}: not conserved"


def phase19(device, errs):
    """B1 (csrc/burgers.cu) against its plain version on the card."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    n, k, b, n_steps = (BURGERS[x] for x in ("n_order", "k", "b", "n_steps"))
    disc = startup_1d(n, 0.0, 2 * np.pi, k)
    dt = BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, dt, "n", device)
    label = f"(a) bench row K={k} N={n} B={b} steps={n_steps} dt={dt:.4e} limiter n"
    b1_double(label, burgers_ics(disc, b, device, torch.float64), n_steps, tab, errs)
    u0 = burgers_ics(disc, b, device, torch.float32)
    want, plain_ms = b1_lockstep(label, u0, n_steps, tab, errs)
    b1_free(label, cb.burgers_march(u0, n_steps, tab), want, n_steps, tab, u0, errs)
    # (b) B = 1 through the single entry point, against the plain run's member 0
    single = cb.make_cuda_burgers_march_single(disc, dt, n_steps, "n", device)
    b1_free("(b) B=1 (make_cuda_burgers_march_single)", single(u0[:, 0]), want[:, 0], n_steps,
            tab, u0[:, :1], errs)
    # (c) the graded mesh, all three limiters, both types
    g = mesh(4, 48, graded=True)
    for lim in ("n", "1", "none"):
        tab_g = cb.burgers_tables(g, 5e-5, lim, device)
        lab = f"(c) graded K=48 N=4 B=8 steps=64 limiter {lim}"
        b1_double(lab, burgers_ics(g, 8, device, torch.float64), 64, tab_g, errs)
        b1_lockstep(lab, burgers_ics(g, 8, device, torch.float32), 64, tab_g, errs)
    # (d) the shock run (burgers_dg's defaults) in float64, step by step over
    # t in [1.4, 1.45] (the shock forms at t = 1) from the kernel's state
    d = startup_1d(4, 0.0, 2 * np.pi, 48)
    tab_d = cb.burgers_tables(d, 2e-4, "n", device)
    u = torch.tensor(0.5 + np.sin(d.x)[:, None, :], dtype=torch.float64, device=device)
    u = cb.burgers_march(u, 7000, tab_d)
    b1_lockstep("(d) shock run K=48 N=4 dt=2e-4 from t=1.4", u, 250, tab_d, errs)
    return plain_ms, (disc, dt)


def burgers_eager64():
    """Start phase 20's float64 eager Burgers march (``burgers_dg --kernel
    torch``: T = 1.5, 7,500 steps at ~13 ms of host a step) on a thread of
    its own. It needs no kernel, and the kernels' build leaves the card and
    a host core idle, so main() starts it before the build and joins it
    after. Returns the join: (u64, wall seconds, burgers_dg's printout);
    it re-raises what the march raised."""
    import contextlib
    import io
    import threading

    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import burgers_dg

    box = {}

    def march():
        out = io.StringIO()
        try:
            t0 = time.perf_counter()
            # the main thread prints nothing until the join
            with contextlib.redirect_stdout(out):
                u = burgers_dg.main(["--kernel", "torch"])
            torch.cuda.synchronize()
            box["result"] = (u, time.perf_counter() - t0, out.getvalue())
        except BaseException as exc:  # re-raised by the join
            box["error"] = exc

    thread = threading.Thread(target=march, name="burgers-eager-f64", daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    return join


def phase20(device, errs, march64):
    """The Burgers path through its entry points; ``march64`` what
    :func:`burgers_eager64`'s join returned."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg, burgers_dg
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    cb.reset_launch_counts()
    t0 = time.perf_counter()
    u = burgers_dg.main(["--kernel", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cb.burgers_march.launches
    disc = startup_1d(4, 0.0, 2 * np.pi, 48)
    n_steps = int(round(1.5 / 2e-4))
    say("20", f"main path burgers_dg --kernel cuda (K=48 N=4 T=1.5 dt=2e-4, {n_steps} steps, "
              f"float32): wall {wall:.3f} s, burgers_march launches {launches}")
    assert launches == 1, launches
    u0 = torch.tensor(0.5 + np.sin(disc.x), dtype=torch.float64, device=device)
    burgers_props("shock run, B1 float32", u, u0.float(), disc, n_steps, EPS32)

    # the float64 eager march ran on a thread beside the kernels' build
    u64, wall64, printed = march64
    print(printed, end="", flush=True)
    assert cb.burgers_march.launches == 1 and u64.dtype == torch.float64
    burgers_props("shock run, --kernel torch float64 on the card", u64, u0, disc, n_steps,
                  2.0**-52)
    tab = cb.burgers_tables(disc, 2e-4, "n", device)
    k64 = cb.burgers_march(u0[:, None, :].contiguous(), n_steps, tab)[:, 0]
    d64 = float((k64 - u64).abs().max())
    say("20", f"--kernel torch float64 (on a thread beside phase 1's build): wall {wall64:.2f} "
              f"s; after the shock, B1 float64 vs it max|d| {d64:.3e} (bound 1e-10) and B1 "
              f"float32 vs it {float((u.double() - u64).abs().max()):.3e} (in float32 roundoff "
              f"decides the troubled-cell test differently; 19(d) holds B1 step by step)")
    # two float64 implementations of the same march (equal at 1e-12 on the
    # CPU, tests/test_torch_burgers.py) after 7,500 steps through the shock
    assert d64 <= 1e-10, "B1 float64 leaves the eager float64 march"
    errs["burgers_march"] = max(errs["burgers_march"], d64)

    # advec_dg limits after every step: float64 on the card against the
    # CPU (float32 would compare two roundings of the troubled-cell test)
    for lim in ("n", "1"):
        err32 = advec_dg.main(["--kernel", "torch", "--limiter", lim])
        err = advec_dg.main(["--kernel", "torch", "--limiter", lim, "--x64"])
        err_cpu = advec_dg.main(["--kernel", "torch", "--limiter", lim, "--x64", "--device", "cpu"])
        say("20", f"advec_dg --kernel torch --limiter {lim} on the card: max error {err32:.6e} "
                  f"(float32), {err:.12e} (float64); --device cpu float64 {err_cpu:.12e}")
        assert np.isfinite(err32) and abs(err - err_cpu) <= 1e-10 * err_cpu
    return launches, wall


REVOLVE_CHECK = dict(k=10_000, n_steps=2048, unit=128, snaps=4)
# bench.py:1501-1560: K = 10^5, N = 2, dt 0.5·(0.75/a)·x_min, sin x, 16,384
# steps, unit 128, 16 snaps; then a step count whose stored trajectory
# (98.3 GB) passes the card's memory
REVOLVE_BENCH = dict(k=100_000, n_steps=16_384, unit=128, snaps=16)
REVOLVE_BEYOND = 81_920


def revolve_case(disc, n_steps, unit, snaps, device):
    """``revolve_advec_estimate`` on ``disc`` at bench.py's CFL step, with
    its inputs: u0 = sin x and the cotangent of J = ∫u(T), float32."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.adjoint.revolve_vjp import revolve_advec_estimate

    dt = cfl_step(disc)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    return revolve_advec_estimate(disc, A, dt, n_steps, unit, snaps, device=device), u0, lam, dt


def phase21(device, errs):
    """Revolve on the card: revolve_advec_estimate against the stored
    pipeline, timed; and a run the stored pipeline cannot make."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.dg_rhs import make_cuda_fwd_adj_estimate_single

    def compare(label, got, want, n_steps, np_, lam):
        tol = tolerances(n_steps, np_, want[0], lam)
        e = [float((g - w).abs().max()) for g, w in zip(got, want)]
        eta_bound = 1e-4 * want[2].abs() + 1e-9  # tests/test_revolve_pipeline.py
        eta_above = int(((got[2] - want[2]).abs() > eta_bound).sum())
        say("21", f"{label}: revolve vs stored u_final {e[0]:.3e} (tol {tol['u']:.3e}) lam0 "
                  f"{e[1]:.3e} (tol {tol['lam']:.3e}) eta {e[2]:.3e} (max|eta| "
                  f"{float(want[2].abs().max()):.3e}; {eta_above} entries above 1e-4·|eta| + 1e-9)")
        assert e[0] <= tol["u"] and e[1] <= tol["lam"] and eta_above == 0, label

    c = REVOLVE_CHECK
    disc = mesh(2, c["k"], graded=False)
    rev, u0, lam, dt = revolve_case(disc, c["n_steps"], c["unit"], c["snaps"], device)
    dg_rhs.reset_launch_counts()
    got = rev(u0, 0.0, lam)
    torch.cuda.synchronize()
    st = rev.revolve_stats
    launches = {"fwd_march": dg_rhs.fwd_march.launches,
                "adj_est_stored": dg_rhs.adj_est_stored.launches}
    say("21", f"(a) revolve_advec_estimate K={c['k']} N=2 steps={c['n_steps']} unit={c['unit']} "
              f"snaps={c['snaps']}: stats {st}; wrapper launches {launches}")
    assert launches == {"fwd_march": st["forward_units"] + st["n_units"],
                        "adj_est_stored": st["n_units"]}, launches
    assert st["max_slots"] <= c["snaps"]
    want = make_cuda_fwd_adj_estimate_single(disc, A, dt, c["n_steps"], device)(u0, 0.0, lam)
    compare("(a)", got, want, c["n_steps"], disc.np_, lam)

    c = REVOLVE_BENCH
    disc = mesh(2, c["k"], graded=False)
    rev, u0, lam, dt = revolve_case(disc, c["n_steps"], c["unit"], c["snaps"], device)
    stored = make_cuda_fwd_adj_estimate_single(disc, A, dt, c["n_steps"], device)
    out = {}
    torch.cuda.empty_cache()
    ms_stored = cuda_ms(lambda: out.update(s=stored(u0, 0.0, lam)), runs=5)
    ms_rev = cuda_ms(lambda: out.update(r=rev(u0, 0.0, lam)), runs=5)
    st = rev.revolve_stats
    dof_steps = disc.np_ * c["k"] * 2 * c["n_steps"]
    traj_gb = c["n_steps"] * disc.np_ * c["k"] * 4 / 1e9
    say("21", f"(b) bench.py's revolve row K={c['k']} steps={c['n_steps']} unit={c['unit']} "
              f"snaps={c['snaps']}: revolve {ms_rev:.1f} ms ({dof_steps / ms_rev * 1e3:.4e} "
              f"fwd+adjoint DoF-steps/s; forward units {st['forward_units']} of {st['n_units']}, "
              f"recompute {st['forward_units'] / st['n_units']:.2f}x); stored pipeline "
              f"{ms_stored:.1f} ms ({traj_gb:.1f} GB trajectory); revolve/stored "
              f"{ms_rev / ms_stored:.3f} (median of 5 each)")
    compare("(b)", out["r"], out["s"], c["n_steps"], disc.np_, lam)
    out.clear()
    # one advance alone: K1 with no trajectory over one unit from a host t0
    # (the TPU's _fwd_grid_kernel_b, dg_rhs.py:1017), and its plain version
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0b = u0[:, None, :].contiguous()
    ms_adv = cuda_ms(lambda: dg_rhs.fwd_march(u0b, 0.5, c["unit"], ops), runs=5)
    plain_adv = cuda_ms(lambda: out.update(p=dg_rhs.fwd_march_plain(u0b, 0.5, c["unit"], ops)[1]),
                        runs=3, warmup=0)
    e_adv = float((dg_rhs.fwd_march(u0b, 0.5, c["unit"], ops)[1] - out.pop("p")).abs().max())
    tol_adv = 8 * c["unit"] * EPS32 * float(u0.abs().max())
    adv_bound = march_bound(2, c["k"], c["unit"])
    say("21", f"(b) one advance (K1, no trajectory, {c['unit']} steps from t0 = 0.5, K={c['k']}): "
              f"kernel {ms_adv:.3f} ms (median of 5, {dg_rhs.fwd_march.cuda_launches} CUDA "
              f"launches), plain {plain_adv:.1f} ms (median of 3), "
              f"bound {adv_bound[0]:.5f} ms ({adv_bound[1]}); max|kernel - plain| {e_adv:.3e} "
              f"(tol {tol_adv:.3e})")
    assert e_adv <= tol_adv
    errs["fwd_march"] = max(errs["fwd_march"], e_adv)
    torch.cuda.empty_cache()

    n_big = REVOLVE_BEYOND
    big = make_cuda_fwd_adj_estimate_single(disc, A, dt, n_big, device)
    try:
        big(u0, 0.0, lam)
    except MemoryError as exc:
        say("21", f"(c) stored pipeline at {n_big} steps: MemoryError: {exc}")
    else:
        raise AssertionError(f"the stored pipeline ran {n_big} steps: nothing beyond memory shown")
    rev_big = revolve_case(disc, n_big, c["unit"], c["snaps"], device)[0]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    ms_big = cuda_ms(lambda: out.update(b=rev_big(u0, 0.0, lam)), runs=1, warmup=0)
    peak = torch.cuda.max_memory_allocated(device) - base
    state = disc.np_ * c["k"] * 4
    bound = (c["snaps"] + c["unit"] + 16) * state
    st = rev_big.revolve_stats
    uf, lam0, eta = out["b"]
    say("21", f"(c) revolve at {n_big} steps ({n_big * state / 1e9:.1f} GB if stored): "
              f"{ms_big:.1f} ms, stats {st}; peak device memory above the inputs "
              f"{peak / 1e6:.1f} MB (bound (snaps + unit + 16)·state = {bound / 1e6:.1f} MB); "
              f"Σeta {float(eta.sum()):+.6e}, J {float(torch.sum(lam * uf)):+.6e}")
    assert st["max_slots"] <= c["snaps"] and peak <= bound
    for x in (uf, lam0, eta):
        assert bool(torch.isfinite(x).all())
    return {"revolve_ms": ms_rev, "stored_ms": ms_stored, "beyond_ms": ms_big,
            "advance": (ms_adv, plain_adv, adv_bound, e_adv),
            "beyond": (out["b"], peak, u0, lam, dt)}


def burgers_stage_ops(np_, limiter="n"):
    """FP32 operations of one B1 stage per element (an FMA counts 2),
    counted from csrc/burgers.cu: phase A — the flux values f (2·Np), the
    face speeds and LLF fluxes (34), the volume product (2·Np²), rx (Np),
    the two lift columns (4·Np), the r and u updates (4·Np), the cell
    average (2·Np); phase B (ΠN) — the slope of the linear part (2·Np + 2),
    the neighbour differences and their scaling (4), three minmods (27),
    the endpoint reconstructions and the troubled test (10), the limited
    nodes and the select (3·Np)."""
    a = 2 * np_ * np_ + 13 * np_ + 34
    return a if limiter == "none" else a + 5 * np_ + 43


def burgers_bound(n_order, k, b, n_steps):
    """B1 at the bench row: u0 and the geometry rows read once, u written
    once (float32), 5 stages of burgers_stage_ops per element and member."""
    np_ = n_order + 1
    return bound(4 * (2 * np_ * b * k + (4 + np_) * k), 5 * n_steps * b * k * burgers_stage_ops(np_))


def burgers_times(device, plain_ms, bench):
    """Phase 22: CUDA-event times of B1 (one warm-up, median of 5) at the
    bench row and at B = 1, beside the bound; the plain version's time is
    the sum of its steps in 19(a)'s step-by-step run (one run: it is
    host-bound, ~60 small launches a stage, ~20 s)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    disc, dt = bench
    n, k, b, n_steps = (BURGERS[x] for x in ("n_order", "k", "b", "n_steps"))
    tab = cb.burgers_tables(disc, dt, "n", device)
    u0 = burgers_ics(disc, b, device, torch.float32)
    ms = cuda_ms(lambda: cb.burgers_march(u0, n_steps, tab), runs=5)
    n_cuda = cb.burgers_march.cuda_launches
    u1 = u0[:, :1].contiguous()
    ms1 = cuda_ms(lambda: cb.burgers_march(u1, n_steps, tab), runs=5)
    b_ms, b_by = burgers_bound(n, k, b, n_steps)
    b1_ms, _ = burgers_bound(n, k, 1, n_steps)
    dofs = b * (n + 1) * k * n_steps
    say("22", f"burgers_march K={k} N={n} B={b} steps={n_steps}: kernel {ms:.3f} ms "
              f"({dofs / ms * 1e3:.4e} DoF-steps/s, {n_cuda} CUDA launches); plain "
              f"{plain_ms:.1f} ms (19(a)'s "
              f"step-by-step run, its {n_steps} steps summed); "
              f"bound {b_ms:.4f} ms ({b_by}), kernel at {b_ms / ms:.3%} of it; B=1 kernel "
              f"{ms1:.3f} ms (bound {b1_ms:.5f} ms)")
    return ms, (b_ms, b_by)


# ------------------------------------------- recompute, unbatched and tiled


# bench.py's batched row as tools/tpu_smoke.py:143-161 runs it with the
# recompute pipeline: K = 10^4, N = 2, B = 8, 2048 steps, segment 4
RECOMPUTE = dict(k=10_000, n_steps=2048, b=8, segment=4)
# bench.py:1374-1378's element-tiled rows: (K, segment, chunks, steps)
TILED_ROWS = ((100_000, 8, 4, 256), (1_000_000, 16, 25, 64))
# phase 21's row past memory through the unbatched recompute pipeline; the
# segment keeps checkpoints plus scratch at (320 + 257)·Np·K·4 B = 0.69 GB
BEYOND_SEGMENT = 256


def advec_bounds(np_, cols, n_steps, n_ckpt=0):
    """Least times of the advection kernels over n_steps on ``cols`` = B·K
    columns (stage_ops per column and stage; inputs read once, outputs
    written once): K1 in checkpoint mode (u0, the geometry, n_ckpt states,
    u_final), K2r (the checkpoints, λ_end, λ0, η, the geometry; the
    recompute's 5 stages, K2's 20 and the η sum per step), KA (λ_end, λ0,
    5 transposed stages a step), KT1 (K1 with the whole trajectory) and
    KT2 (K2: the trajectory, u_final, λ_end, λ0, η)."""
    state, geom, stage = 4 * np_ * cols, 3 * 4 * cols, stage_ops(np_)
    return {
        "fwd_march_ckpt": bound(2 * state + geom + n_ckpt * state, n_steps * 5 * stage * cols),
        "adj_est_recompute": bound(n_ckpt * state + 2 * state + geom + 4 * cols,
                                   n_steps * (25 * stage + 3 * np_) * cols),
        "adj_march": bound(2 * state + geom, n_steps * 5 * stage * cols),
        "tiled_fwd_seg": bound(2 * state + geom + n_steps * state, n_steps * 5 * stage * cols),
        "tiled_rev_seg": bound(n_steps * state + 3 * state + geom + 4 * cols,
                               n_steps * (20 * stage + 3 * np_) * cols),
    }


def recompute_check(label, disc, b, n_steps, segment, device, errs):
    """K1 in checkpoint mode, K2r and KA against their plain versions on
    the same inputs, and K2r against K2 bit for bit."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, b, device, torch.float32)
    lam = batched_cotangent(disc, b, device, torch.float32)
    ckpts, uf = dg_rhs.fwd_march_ckpt(u0, 0.0, n_steps, segment, ops)
    lam0, eta = dg_rhs.adj_est_recompute(ckpts, lam, 0.0, segment, ops)
    lam_a = dg_rhs.adj_march(lam, n_steps, ops)
    traj, uf_s = dg_rhs.fwd_march(u0, 0.0, n_steps, ops, store_trajectory=True)
    lam0_s, eta_s = dg_rhs.adj_est_stored(traj, uf_s, lam, 0.0, ops)
    torch.cuda.synchronize()
    ck_p, uf_p = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, checkpoint_every=segment)
    lam0_p, eta_p = dg_rhs.adj_est_recompute_plain(ckpts, lam, 0.0, segment, ops)
    lam_ap = dg_rhs.adj_march_plain(lam, n_steps, ops)
    tol = tolerances(n_steps, disc.np_, uf_p, lam)
    e = {"ckpt": max(float((ckpts - ck_p).abs().max()), float((uf - uf_p).abs().max())),
         "lam0": float((lam0 - lam0_p).abs().max()), "eta": float((eta - eta_p).abs().max()),
         "adj": float((lam_a - lam_ap).abs().max())}
    bits = [bool(torch.equal(x, y)) for x, y in
            ((ckpts, traj[::segment]), (uf, uf_s), (lam0, lam0_s), (eta, eta_s))]
    say("23", f"{label}: Np={disc.np_} K={disc.k} B={b} steps={n_steps} segment={segment} | "
              f"K1 ckpt {e['ckpt']:.3e} (tol {tol['u']:.3e}) | K2r lam0 {e['lam0']:.3e} "
              f"(tol {tol['lam']:.3e}) eta {e['eta']:.3e} (tol {tol['eta']:.3e}) | KA "
              f"{e['adj']:.3e} (tol {tol['lam']:.3e}) | bit-equal to K1/K2 (ckpts, u, lam0, eta): "
              f"{bits}")
    assert e["ckpt"] <= tol["u"], f"{label}: K1's checkpoint mode disagrees"
    assert e["lam0"] <= tol["lam"] and e["eta"] <= tol["eta"], f"{label}: K2r disagrees"
    assert e["adj"] <= tol["lam"], f"{label}: KA disagrees"
    assert all(bits), f"{label}: the recompute pipeline is not the stored one"
    errs["fwd_march_ckpt"] = max(errs["fwd_march_ckpt"], e["ckpt"])
    errs["adj_est_recompute"] = max(errs["adj_est_recompute"], e["lam0"], e["eta"])
    errs["adj_march"] = max(errs["adj_march"], e["adj"])


def phase23(device, errs):
    """The recompute pipeline and the unbatched entry points on the card."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt import advec_loop
    from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    recompute_check("(a) graded", mesh(2, 24, graded=True), 8, 64, 4, device, errs)
    recompute_check("(a) N=7", mesh(7, 24, graded=False), 8, 64, 16, device, errs)

    # (b) the main path: the adaptive study through its driver with the
    # card's free memory reported as 0, so the loop takes the recompute
    # pipeline; its history must be the stored study's, bit for bit
    argv = ["--adapt", "--kernel", "cuda", "--k", "512", "--order", "2",
            "--final-time", "0.25", "--maxit", "4"]
    hist_s = advec_dg.main(argv)
    free = advec_loop._free_device_bytes
    advec_loop._free_device_bytes = lambda device: 0
    try:
        dg_rhs.reset_launch_counts()
        t0 = time.perf_counter()
        hist_r = advec_dg.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(dg_rhs, name).launches for name in
                    ("fwd_march", "adj_est_stored", "fwd_march_ckpt", "adj_est_recompute")}
    finally:
        advec_loop._free_device_bytes = free
    same = all(np.array_equal(a.vx, b.vx) and np.array_equal(a.eta, b.eta)
               and a.j_value == b.j_value for a, b in zip(hist_s, hist_r))
    say("23", f"(b) main path advec_dg {' '.join(argv)} with no free memory reported: "
              f"{len(hist_r)} iterations, wall {wall:.3f} s, wrapper launches {launches}; "
              f"history (vertices, eta, J) bit-equal to the stored study's: {same}")
    assert launches == {"fwd_march": 0, "adj_est_stored": 0, "fwd_march_ckpt": len(hist_r),
                        "adj_est_recompute": len(hist_r)}, launches
    assert same and len(hist_r) == len(hist_s)

    # (c) bench.py's batched row: the recompute pipeline against the stored
    # one in the same call (the same stage kernels at the same times: u, λ0
    # and η bit-equal), both timed; each kernel alone and its plain version
    c = RECOMPUTE
    disc = mesh(2, c["k"], graded=False)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = phased_states(disc, c["b"], device, torch.float32)
    lam = batched_cotangent(disc, c["b"], device, torch.float32)
    rec = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, c["n_steps"], c["b"], device,
                                                         segment=c["segment"])
    sto = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, c["n_steps"], c["b"], device,
                                                         store_trajectory=True)
    out = {}
    turns = in_turns({"stored": lambda: out.update(s=sto(u0, 0.0, lam)),
                      "recompute": lambda: out.update(r=rec(u0, 0.0, lam))})
    ms_sto, ms_rec = (statistics.mean(turns[name]) for name in ("stored", "recompute"))
    bits = [bool(torch.equal(x, y)) for x, y in zip(out["r"], out["s"])]
    diffs = [float((x - y).abs().max()) for x, y in zip(out["r"], out["s"])]
    n_seg = c["n_steps"] // c["segment"]
    dofs = c["b"] * disc.np_ * c["k"] * 2 * c["n_steps"]
    say("23", f"(c) bench row K={c['k']} N=2 B={c['b']} steps={c['n_steps']} segment={c['segment']}: "
              f"recompute {ms_rec:.3f} ms ({dofs / ms_rec * 1e3:.4e} fwd+adjoint DoF-steps/s, "
              f"{dg_rhs.fwd_march_ckpt.cuda_launches + dg_rhs.adj_est_recompute.cuda_launches} "
              f"CUDA launches, {(n_seg + c['segment'] + 1) * 4 * disc.np_ * c['b'] * c['k'] / 1e6:.1f} "
              f"MB of states); stored {ms_sto:.3f} ms "
              f"({dg_rhs.fwd_march.cuda_launches + dg_rhs.adj_est_stored.cuda_launches} launches, "
              f"{c['n_steps'] * 4 * disc.np_ * c['b'] * c['k'] / 1e6:.1f} MB); recompute/stored "
              f"{ms_rec / ms_sto:.3f} (in turns stored, recompute, recompute, stored, median of 5 "
              f"each: stored {turns['stored'][0]:.3f} / {turns['stored'][1]:.3f}, recompute "
              f"{turns['recompute'][0]:.3f} / {turns['recompute'][1]:.3f} ms); u_final, lam0, eta "
              f"bit-equal: {bits} (max |d| {diffs})")
    assert all(bits), "the recompute pipeline is not the stored one at the bench row"
    ms_k1 = cuda_ms(lambda: out.update(k1=dg_rhs.fwd_march_ckpt(u0, 0.0, c["n_steps"], c["segment"], ops)),
                    runs=5)
    ckpts, uf = out.pop("k1")
    ms_k2r = cuda_ms(lambda: out.update(k2=dg_rhs.adj_est_recompute(ckpts, lam, 0.0, c["segment"], ops)),
                     runs=5)
    plain_k1 = cuda_ms(lambda: out.update(p1=dg_rhs.fwd_march_plain(
        u0, 0.0, c["n_steps"], ops, checkpoint_every=c["segment"])), runs=1, warmup=0)
    plain_k2r = cuda_ms(lambda: out.update(p2=dg_rhs.adj_est_recompute_plain(
        ckpts, lam, 0.0, c["segment"], ops)), runs=1, warmup=0)
    tol = tolerances(c["n_steps"], disc.np_, out["p1"][1], lam)
    e1 = max(float((ckpts - out["p1"][0]).abs().max()), float((uf - out["p1"][1]).abs().max()))
    e2 = [float((x - y).abs().max()) for x, y in zip(out["k2"], out["p2"])]
    say("23", f"(c) K1 checkpoint mode {ms_k1:.3f} ms ({dg_rhs.fwd_march_ckpt.cuda_launches} CUDA "
              f"launches), K2r {ms_k2r:.3f} ms (median of 5); plain "
              f"{plain_k1:.1f} / {plain_k2r:.1f} ms (one run each); kernel vs plain: ckpts+u "
              f"{e1:.3e} (tol {tol['u']:.3e}), lam0 {e2[0]:.3e} (tol {tol['lam']:.3e}), eta "
              f"{e2[1]:.3e} (tol {tol['eta']:.3e})")
    assert e1 <= tol["u"] and e2[0] <= tol["lam"] and e2[1] <= tol["eta"]
    errs["fwd_march_ckpt"] = max(errs["fwd_march_ckpt"], e1)
    errs["adj_est_recompute"] = max(errs["adj_est_recompute"], *e2)
    out.clear()

    # (d) the unbatched entry points at B = 1 on the bench mesh: the pure
    # adjoint march (KA) against its plain version, timed, with its launch
    # count; the two unbatched estimates against the stored single pipeline
    u1 = u0[:, 0].contiguous()
    lam1 = lam[:, 0].contiguous()
    adjoint = dg_rhs.make_cuda_advec_adjoint(disc, A, dt, steps_per_call=256, device=device)
    dg_rhs.reset_launch_counts()
    lam_a = adjoint(lam1, c["n_steps"] // 256)
    torch.cuda.synchronize()
    ka_launches = dg_rhs.adj_march.launches
    ms_ka = cuda_ms(lambda: adjoint(lam1, c["n_steps"] // 256), runs=5)
    ka_ops = dg_rhs.kernel_ops(disc, A, dt, device)
    plain_ka = cuda_ms(lambda: out.update(pa=dg_rhs.adj_march_plain(lam1[:, None], c["n_steps"], ka_ops)),
                       runs=1, warmup=0)
    e_ka = float((lam_a - out.pop("pa")[:, 0]).abs().max())
    tol_ka = 8 * c["n_steps"] * EPS32 * float(lam1.abs().max())
    ka_plan = dg_rhs.adjoint_plan(c["k"], 1, disc.np_, c["n_steps"], dg_rhs._sm_count(device))
    say("23", f"(d) make_cuda_advec_adjoint K={c['k']} B=1 steps={c['n_steps']}: KA {ms_ka:.3f} ms "
              f"(median of 5, {dg_rhs.adj_march.cuda_launches} CUDA launches), plain "
              f"{plain_ka:.1f} ms (one run); max|kernel - plain| {e_ka:.3e} (tol {tol_ka:.3e}); "
              f"wrapper launches {ka_launches}")
    assert ka_launches == 1 and e_ka <= tol_ka
    assert dg_rhs.adj_march.cuda_launches == -(-c["n_steps"] // ka_plan.segment)
    errs["adj_march"] = max(errs["adj_march"], e_ka)
    single = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, c["n_steps"], device)(u1, 0.0, lam1)
    chunked = dg_rhs.make_cuda_fwd_adj_estimate(disc, A, dt, segment=32, device=device)(
        u1, 0.0, c["n_steps"] // 32, lam1)
    grid = dg_rhs.make_cuda_fwd_adj_estimate_grid(disc, A, dt, segment=32,
                                                  n_segments=c["n_steps"] // 32, device=device)(
        u1, 0.0, lam1)
    same = [bool(torch.equal(x, y)) for got in (chunked, grid) for x, y in zip(got, single)]
    say("23", f"(d) make_cuda_fwd_adj_estimate and _grid (segment 32) against the stored single "
              f"pipeline: u_final, lam0, eta bit-equal {same}")
    assert all(same)
    bounds = advec_bounds(disc.np_, c["b"] * c["k"], c["n_steps"], n_seg)
    bounds["adj_march"] = advec_bounds(disc.np_, c["k"], c["n_steps"])["adj_march"]
    launches = {"fwd_march_ckpt": launches["fwd_march_ckpt"],
                "adj_est_recompute": launches["adj_est_recompute"], "adj_march": ka_launches}
    times = {"fwd_march_ckpt": (ms_k1, plain_k1), "adj_est_recompute": (ms_k2r, plain_k2r),
             "adj_march": (ms_ka, plain_ka)}
    return launches, times, {k: bounds[k] for k in times}


def phase24(device, errs):
    """The element-tiled pipeline at bench.py's rows against the stored one."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    # (a) KT1/KT2 against their plain version (the same tiles and windows)
    # at a small shape, tiles narrower than a chunk
    disc = startup_1d(2, 0.0, 2 * np.pi, 640)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    plan = dg_tiled.tile_plan(640, disc.np_, 2, 30, 160, tile=50)
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, 4, plan, ops)
    lam0, eta = dg_tiled.tiled_rev_seg(traj, uf, lam, 0.0, plan, ops)
    torch.cuda.synchronize()
    traj_p, uf_p = dg_tiled.tiled_fwd_seg_plain(u0, 0.0, 4, plan, ops)
    lam0_p, eta_p = dg_tiled.tiled_rev_seg_plain(traj, uf, lam, 0.0, plan, ops)
    tol = tolerances(8, disc.np_, uf_p, lam)
    e = [float((x - y).abs().max()) for x, y in ((traj, traj_p), (uf, uf_p), (lam0, lam0_p), (eta, eta_p))]
    say("24", f"(a) K=640 N=2 segment 2, {plan.n_tiles} tiles of {plan.tile} + 2x{plan.ghost} "
              f"ghosts, 8 steps: KT1 traj {e[0]:.3e} u_final {e[1]:.3e} (tol {tol['u']:.3e}) | KT2 "
              f"lam0 {e[2]:.3e} (tol {tol['lam']:.3e}) eta {e[3]:.3e} (tol {tol['eta']:.3e})")
    assert max(e[:2]) <= tol["u"] and e[2] <= tol["lam"] and e[3] <= tol["eta"]
    errs["tiled_fwd_seg"] = max(errs["tiled_fwd_seg"], *e[:2])
    errs["tiled_rev_seg"] = max(errs["tiled_rev_seg"], *e[2:])
    # KT2 runs K2's fused kernel at B = 1: the stored pipeline's K2 on the
    # same trajectory gives its bits, and so do narrow fused tiles and the
    # sweep one segment a call from the global step offset with η carried in
    want = dg_rhs.adj_est_stored(traj[:, :, None], uf[:, None], lam[:, None], 0.0, ops)
    want = (want[0][:, 0], want[1][0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fused = dg_rhs.stored_plan(640, 1, disc.np_, 8, sms)
    n_cuda = dg_tiled.tiled_rev_seg.cuda_launches
    variants = {"the wrapper": (lam0, eta)}
    for tile in (5, 50):
        narrow = dg_rhs.fused_plan(640, 4, 512)._replace(tile=tile, n_tiles=-(-640 // tile))
        variants[f"fused tiles of {tile}"] = dg_tiled._kt2_launch(traj, uf, lam, 0.0, ops, narrow)[:2]
    lam_s, eta_s = lam, None
    for si in reversed(range(4)):
        seg_traj = traj[2 * si:2 * si + 2]
        u_end = uf if si == 3 else traj[2 * si + 2]
        lam_s, eta_s = dg_tiled.tiled_rev_seg(seg_traj, u_end, lam_s, 0.0, plan, ops, si, eta_s)
    variants["one segment a call"] = (lam_s, eta_s)
    torch.cuda.synchronize()
    same = {key: all(bool(torch.equal(x, y)) for x, y in zip(v, want)) for key, v in variants.items()}
    say("24", f"(a) KT2 on stored_plan's windows (s_f={fused.segment}, {fused.n_tiles} tile(s) of "
              f"{fused.tile} + 2x{fused.ghost}, {n_cuda} CUDA launches): lam0 and eta bit-equal to "
              f"the stored pipeline's K2 on the same trajectory: {same}")
    assert all(same.values()), "KT2 is not the stored pipeline's bits"

    # (b) the rows, both factories against the stored K1/K2 pipeline: every
    # local element runs K1's/K2's arithmetic at the same times, so u_final,
    # lam0 and eta are expected bit-equal (bound 0 per entry)
    launches, times, bounds, plans = {}, {}, {}, {}
    for k, seg, chunks, n_steps in TILED_ROWS:
        disc = startup_1d(2, 0.0, 2 * np.pi, k)
        dt = cfl_step(disc)
        ops = dg_rhs.kernel_ops(disc, A, dt, device)
        u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
        lam = terminal_integral_cotangent(disc, torch.float32, device)
        stored = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, n_steps, device)
        runs = {name: make(disc, A, dt, segment=seg, n_segments=n_steps // seg, chunks=chunks,
                           device=device)
                for name, make in (("tiled_grid", dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid),
                                   ("tiled", dg_tiled.make_cuda_fwd_adj_estimate_tiled))}
        out = {}
        if k == TILED_ROWS[-1][0]:  # the main path's count: tiled_grid at K = 10^6
            dg_tiled.reset_launch_counts()
            runs["tiled_grid"](u0, 0.0, lam)
            torch.cuda.synchronize()
            launches = {"tiled_fwd_seg": dg_tiled.tiled_fwd_seg.launches,
                        "tiled_rev_seg": dg_tiled.tiled_rev_seg.launches}
            assert launches == {"tiled_fwd_seg": 1, "tiled_rev_seg": 1}, launches
        turns = in_turns({"stored": lambda: out.update(stored=stored(u0, 0.0, lam)),
                          **{name: (lambda name=name: out.update({name: runs[name](u0, 0.0, lam)}))
                             for name in runs}})
        ms_sto = statistics.mean(turns["stored"])
        for name, run in runs.items():
            p = plans[name] = run.plan
            ms = statistics.mean(turns[name])
            d = [float((x - y).abs().max()) for x, y in zip(out[name], out["stored"])]
            say("24", f"(b) {name} K={k} N=2 segment={seg} chunks={chunks} steps={n_steps}: "
                      f"{p.n_tiles} CTA tiles of {p.tile} + 2x{p.ghost} ghosts (ghost overhead "
                      f"2W/L = {2 * p.ghost / p.tile:.1%}); {ms:.3f} ms "
                      f"({dg_tiled.tiled_fwd_seg.cuda_launches + dg_tiled.tiled_rev_seg.cuda_launches}"
                      f" CUDA launches) against the stored pipeline's {ms_sto:.3f} ms "
                      f"({dg_rhs.fwd_march.cuda_launches + dg_rhs.adj_est_stored.cuda_launches} "
                      f"launches), tiled/stored {ms / ms_sto:.3f} (in turns stored, tiled_grid, "
                      f"tiled, tiled, tiled_grid, stored, median of 5 each: {name} "
                      f"{turns[name][0]:.3f} / {turns[name][1]:.3f}, stored {turns['stored'][0]:.3f} "
                      f"/ {turns['stored'][1]:.3f} ms); max|tiled - stored| u_final {d[0]:.3e} lam0 "
                      f"{d[1]:.3e} eta {d[2]:.3e} (bound 0: bit-equal expected)")
            assert d == [0.0, 0.0, 0.0], f"{name} K={k}: not the stored pipeline's bits"
        for x in out["stored"]:
            assert bool(torch.isfinite(x).all())
        if k == TILED_ROWS[-1][0]:
            # each kernel alone at the main path's row (tiled_grid's tiles),
            # and the plain version of the same function (K1's and K2's: the
            # tiling is exact)
            p = plans["tiled_grid"]
            ms_kt1 = cuda_ms(lambda: out.update(k1=dg_tiled.tiled_fwd_seg(
                u0, 0.0, n_steps // seg, p, ops)), runs=5)
            traj, uf = out.pop("k1")
            ms_kt2 = cuda_ms(lambda: out.update(k2=dg_tiled.tiled_rev_seg(
                traj, uf, lam, 0.0, p, ops)), runs=5)
            plain1 = cuda_ms(lambda: out.update(p1=dg_rhs.fwd_march_plain(
                u0[:, None], 0.0, n_steps, ops, True)), runs=1, warmup=0)
            traj_p, uf_p = out.pop("p1")
            plain2 = cuda_ms(lambda: out.update(p2=dg_rhs.adj_est_stored_plain(
                traj[:, :, None], uf[:, None], lam[:, None], 0.0, ops)), runs=1, warmup=0)
            tol = tolerances(n_steps, disc.np_, uf_p, lam)
            e1 = max(float((traj - traj_p[:, :, 0]).abs().max()), float((uf - uf_p[:, 0]).abs().max()))
            lam0_p, eta_p = out.pop("p2")
            e2 = [float((out["k2"][0] - lam0_p[:, 0]).abs().max()),
                  float((out["k2"][1] - eta_p[0]).abs().max())]
            kt2 = dg_rhs.stored_plan(k, 1, disc.np_, n_steps,
                                     torch.cuda.get_device_properties(device).multi_processor_count)
            kt1 = dg_rhs.forward_plan(k, 1, disc.np_, n_steps, 1,
                                      torch.cuda.get_device_properties(device).multi_processor_count)
            say("24", f"(c) K={k} segment={seg}: KT1 {ms_kt1:.3f} ms, KT2 {ms_kt2:.3f} ms (median "
                      f"of 5; KT1 on s_f={kt1.segment}, {kt1.n_tiles} CTAs of {kt1.tile} + "
                      f"2x{kt1.ghost} on {kt1.threads} threads, "
                      f"{dg_tiled.tiled_fwd_seg.cuda_launches} CUDA launches; KT2 on s_f={kt2.segment}, {kt2.n_tiles} CTAs of {kt2.tile} + "
                      f"2x{kt2.ghost} on {kt2.threads} threads, "
                      f"{dg_tiled.tiled_rev_seg.cuda_launches} CUDA launches); plain (K1's and K2's plain versions) {plain1:.1f} / {plain2:.1f} ms "
                      f"(one run each); kernel vs plain: traj+u {e1:.3e} (tol {tol['u']:.3e}), lam0 "
                      f"{e2[0]:.3e} (tol {tol['lam']:.3e}), eta {e2[1]:.3e} (tol {tol['eta']:.3e})")
            assert e1 <= tol["u"] and e2[0] <= tol["lam"] and e2[1] <= tol["eta"]
            errs["tiled_fwd_seg"] = max(errs["tiled_fwd_seg"], e1)
            errs["tiled_rev_seg"] = max(errs["tiled_rev_seg"], *e2)
            times = {"tiled_fwd_seg": (ms_kt1, plain1), "tiled_rev_seg": (ms_kt2, plain2)}
            b = advec_bounds(disc.np_, k, n_steps)
            bounds = {name: b[name] for name in times}
        del out
        torch.cuda.empty_cache()
    return launches, times, bounds


def phase25(device, beyond):
    """The unbatched recompute pipeline past the card's memory, beside
    revolve's run of phase 21(c) on the same inputs."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    (uf_r, lam0_r, eta_r), peak_rev, u0, lam, dt = beyond
    k, n_steps, seg = REVOLVE_BENCH["k"], REVOLVE_BEYOND, BEYOND_SEGMENT
    disc = mesh(2, k, graded=False)
    assert abs(cfl_step(disc) - dt) == 0.0
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid(disc, A, dt, segment=seg,
                                                 n_segments=n_steps // seg, device=device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = {}
    ms = cuda_ms(lambda: out.update(r=run(u0, 0.0, lam)), runs=1, warmup=0)
    peak = torch.cuda.max_memory_allocated(device) - base
    uf, lam0, eta = out["r"]
    state = disc.np_ * k * 4
    tol = tolerances(n_steps, disc.np_, uf_r, lam)
    d = [float((x - y).abs().max()) for x, y in ((uf, uf_r), (lam0, lam0_r), (eta, eta_r))]
    eta_bound = 1e-4 * eta_r.abs() + 1e-9  # tests/test_revolve_pipeline.py
    eta_above = int(((eta - eta_r).abs() > eta_bound).sum())
    dofs = disc.np_ * k * 2 * n_steps
    say("25", f"make_cuda_fwd_adj_estimate_grid K={k} N=2 steps={n_steps} segment={seg} "
              f"({n_steps * state / 1e9:.1f} GB if stored): {ms:.1f} ms ({dofs / ms * 1e3:.4e} "
              f"fwd+adjoint DoF-steps/s, {dg_rhs.fwd_march_ckpt.cuda_launches + dg_rhs.adj_est_recompute.cuda_launches} CUDA launches); peak device memory above "
              f"the inputs {peak / 1e6:.1f} MB (checkpoints + scratch "
              f"{(n_steps // seg + seg + 1) * state / 1e6:.1f} MB) against revolve's "
              f"{peak_rev / 1e6:.1f} MB in phase 21(c); against revolve: u_final {d[0]:.3e} (tol "
              f"{tol['u']:.3e}) lam0 {d[1]:.3e} (tol {tol['lam']:.3e}) eta {d[2]:.3e} (max|eta| "
              f"{float(eta_r.abs().max()):.3e}; {eta_above} entries above 1e-4·|eta| + 1e-9); "
              f"Σeta {float(eta.sum()):+.6e} (revolve {float(eta_r.sum()):+.6e})")
    assert d[0] <= tol["u"] and d[1] <= tol["lam"] and eta_above == 0
    assert peak <= (n_steps // seg + seg + 1 + 16) * state
    for x in (uf, lam0, eta):
        assert bool(torch.isfinite(x).all())
    return ms


# ---------------------------------------- the MXU layout and the sharded pipelines


# phase 26's cases: (N, K, dt, segment) at tests/test_pallas_mxu.py's steps, Np 2, 3, 8
MXU_CASES = ((1, 24, 2e-4, 4), (2, 64, 2e-4, 4), (7, 24, 5e-5, 4))
# BASELINE.md:61's row (the TPU's MXU measurement: N=7, K=10^4, seg 2, 256
# steps) and the headline row (N=2, K=10^4, 2048 steps), B = 8: (N, segment, steps)
MXU_ROWS = ((7, 2, 256), (2, 4, 2048))
# phase 24(b)'s K = 10^6 row for the sharded pipelines, and dg_shard's float64 row
SHARDED = dict(k=1_000_000, segment=16, n_steps=64, chunks=25, world=2)
SHARD_F64 = dict(k=10_000, n_steps=64, segment=16)


def mxu_run(disc, dt, segment, n_steps, device):
    """The MXU entry point and the stored K1/K2 pipeline on bench.py's
    batched ICs at B = 8."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    km = dg_mxu.make_cuda_fwd_adj_estimate_grid_mxu(disc, A, dt, segment=segment,
                                                    n_segments=n_steps // segment, batch=8,
                                                    device=device)
    k12 = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, 8, device,
                                                         store_trajectory=True)
    u0 = phased_states(disc, 8, device, torch.float32)
    lam = batched_cotangent(disc, 8, device, torch.float32)
    return km, k12, u0, lam


def phase26(device, errs):
    """KM1/KM2 against their plain version, and against the stored K1/K2
    pipeline on the same inputs at tests/test_pallas_mxu.py's tolerances."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu

    for n_order, k, dt, seg in MXU_CASES:
        disc = mesh(n_order, k, graded=False)
        n_steps = 4 * seg
        km, k12, u0, lam = mxu_run(disc, dt, seg, n_steps, device)
        got = km(u0, 0.1, lam)
        torch.cuda.synchronize()
        flat = (disc.np_, 8 * k)
        traj_p, uf_p = dg_mxu.km_fwd_traj_plain(u0.reshape(flat), 0.1, km.ops)
        lam0_p, eta_p = dg_mxu.km_adj_est_plain(traj_p, uf_p, lam.reshape(flat), 0.1, km.ops)
        tol = tolerances(n_steps, disc.np_, uf_p, lam)
        e = [float((g.reshape(p.shape) - p).abs().max()) for g, p in zip(got, (uf_p, lam0_p, eta_p))]
        bits = [bool(torch.equal(g.reshape(p.shape), p)) for g, p in zip(got, (uf_p, lam0_p, eta_p))]
        want = k12(u0, 0.1, lam)
        jax_tol = ((2e-4, 1e-6), (2e-3, 2e-5), (5e-3, 1e-7))  # tests/test_pallas_mxu.py:51-61
        excess = [float(((g - w).abs() - (atol + rtol * w.abs())).max())
                  for g, w, (rtol, atol) in zip(got, want, jax_tol)]
        d = [float((g - w).abs().max()) for g, w in zip(got, want)]
        say("26", f"N={n_order} (Np={disc.np_}) K={k} B=8 dt={dt:g} segment={seg} steps={n_steps}: "
                  f"KM1 u_final {e[0]:.3e} (tol {tol['u']:.3e}) | KM2 lam0 {e[1]:.3e} (tol "
                  f"{tol['lam']:.3e}) eta {e[2]:.3e} (tol {tol['eta']:.3e}) | bit-equal to the "
                  f"plain version (u, lam0, eta) {bits} | against K1/K2 max|d| u {d[0]:.3e} lam0 "
                  f"{d[1]:.3e} eta {d[2]:.3e} (max|eta| {float(want[2].abs().max()):.3e}), largest "
                  f"excess over rtol/atol (2e-4/1e-6, 2e-3/2e-5, 5e-3/1e-7) {max(excess):.3e}")
        assert e[0] <= tol["u"] and e[1] <= tol["lam"] and e[2] <= tol["eta"], "KM vs plain"
        assert max(excess) <= 0.0, "KM vs K1/K2 past tests/test_pallas_mxu.py's tolerances"
        for x in got:
            assert bool(torch.isfinite(x).all())
        errs["mxu_fwd_traj"] = max(errs["mxu_fwd_traj"], e[0])
        errs["mxu_adj_est"] = max(errs["mxu_adj_est"], *e[1:])


def mxu_bounds(np_, cols, n_steps):
    """KM1: u0 read, the trajectory and u_final written, 5 stages a step;
    KM2: the trajectory, u_final and λ_end read, λ0 and η written, 20
    stages a step and the η sum (stage_ops per column and stage, as K1/K2)."""
    state, stage = 4 * np_ * cols, stage_ops(np_)
    return {
        "mxu_fwd_traj": bound(state + n_steps * state + state, n_steps * 5 * stage * cols),
        "mxu_adj_est": bound(n_steps * state + 3 * state + 4 * cols,
                             n_steps * (20 * stage + 3 * np_) * cols),
    }


def phase27(device, errs):
    """KM1+KM2 against K1+K2, timed in turns at BASELINE.md:61's row and at
    the headline row; each KM kernel alone and its plain version at the
    first."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    launches, times, bounds = {}, {}, {}
    for n_order, seg, n_steps in MXU_ROWS:
        disc = mesh(n_order, 10_000, graded=False)
        dt = cfl_step(disc)
        km, k12, u0, lam = mxu_run(disc, dt, seg, n_steps, device)
        out = {}
        if n_order == MXU_ROWS[0][0]:  # the main path's count: one call of the entry point
            dg_mxu.reset_launch_counts()
            out["km"] = km(u0, 0.0, lam)
            torch.cuda.synchronize()
            launches = {"mxu_fwd_traj": dg_mxu.km_fwd_traj.launches,
                        "mxu_adj_est": dg_mxu.km_adj_est.launches}
            assert launches == {"mxu_fwd_traj": 1, "mxu_adj_est": 1}, launches
        turns = in_turns({"K1+K2": lambda: out.update(k12=k12(u0, 0.0, lam)),
                          "KM1+KM2": lambda: out.update(km=km(u0, 0.0, lam))})
        ms_k12, ms_km = (statistics.mean(turns[name]) for name in ("K1+K2", "KM1+KM2"))
        d = [float((g - w).abs().max()) for g, w in zip(out["km"], out["k12"])]
        dofs = 8 * disc.np_ * 10_000 * 2 * n_steps
        say("27", f"N={n_order} K=10000 B=8 segment={seg} steps={n_steps}: KM1+KM2 {ms_km:.3f} ms "
                  f"({dofs / ms_km * 1e3:.4e} fwd+adjoint DoF-steps/s), K1+K2 {ms_k12:.3f} ms "
                  f"({dofs / ms_k12 * 1e3:.4e}); CUDA launches KM "
                  f"{dg_mxu.km_fwd_traj.cuda_launches + dg_mxu.km_adj_est.cuda_launches} (KM1 "
                  f"{dg_mxu.km_fwd_traj.cuda_launches}, KM2 {dg_mxu.km_adj_est.cuda_launches}), K1+K2 "
                  f"{dg_rhs.fwd_march.cuda_launches + dg_rhs.adj_est_stored.cuda_launches} (in turns K1+K2, "
                  f"KM1+KM2, KM1+KM2, K1+K2, median of 5 each: KM {turns['KM1+KM2'][0]:.3f} / "
                  f"{turns['KM1+KM2'][1]:.3f}, K1K2 {turns['K1+K2'][0]:.3f} / "
                  f"{turns['K1+K2'][1]:.3f} ms); max|KM - K1K2| u {d[0]:.3e} lam0 {d[1]:.3e} eta "
                  f"{d[2]:.3e}")
        say("27", f"KM/K1K2 at N={n_order}: {ms_km / ms_k12:.3f}")
        for x in out["km"]:
            assert bool(torch.isfinite(x).all())
        if n_order == MXU_ROWS[0][0]:
            flat = (disc.np_, 8 * 10_000)
            ops = km.ops
            ms1 = cuda_ms(lambda: out.update(k1=dg_mxu.km_fwd_traj(u0.reshape(flat), 0.0, ops)), 5)
            traj, uf = out.pop("k1")
            ms2 = cuda_ms(lambda: out.update(k2=dg_mxu.km_adj_est(traj, uf, lam.reshape(flat),
                                                                  0.0, ops)), 5)
            p1 = cuda_ms(lambda: out.update(p1=dg_mxu.km_fwd_traj_plain(u0.reshape(flat), 0.0, ops)),
                         runs=1, warmup=0)
            p2 = cuda_ms(lambda: out.update(p2=dg_mxu.km_adj_est_plain(traj, uf, lam.reshape(flat),
                                                                       0.0, ops)), runs=1, warmup=0)
            tol = tolerances(n_steps, disc.np_, out["p1"][1], lam)
            e1 = max(float((traj - out["p1"][0]).abs().max()), float((uf - out["p1"][1]).abs().max()))
            e2 = [float((x - y).abs().max()) for x, y in zip(out["k2"], out["p2"])]
            bounds = mxu_bounds(disc.np_, 8 * 10_000, n_steps)
            say("27", f"N={n_order}: KM1 {ms1:.3f} ms, KM2 {ms2:.3f} ms (median of 5; bounds "
                      f"{bounds['mxu_fwd_traj'][0]:.4f} / {bounds['mxu_adj_est'][0]:.4f} ms, "
                      f"{bounds['mxu_fwd_traj'][1]} / {bounds['mxu_adj_est'][1]}); plain "
                      f"{p1:.1f} / {p2:.1f} ms (one run each); kernel vs plain traj+u {e1:.3e} "
                      f"(tol {tol['u']:.3e}) lam0 {e2[0]:.3e} (tol {tol['lam']:.3e}) eta "
                      f"{e2[1]:.3e} (tol {tol['eta']:.3e})")
            assert e1 <= tol["u"] and e2[0] <= tol["lam"] and e2[1] <= tol["eta"]
            errs["mxu_fwd_traj"] = max(errs["mxu_fwd_traj"], e1)
            errs["mxu_adj_est"] = max(errs["mxu_adj_est"], *e2)
            times = {"mxu_fwd_traj": (ms1, p1), "mxu_adj_est": (ms2, p2)}
        del out
        torch.cuda.empty_cache()
    return launches, times, bounds


def sharded_inputs(device, dtype):
    """Phase 24(b)'s K = 10^6 row: u0 = sin x, J = ∫u(T), the CFL step."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d

    disc = startup_1d(2, 0.0, 2 * np.pi, SHARDED["k"])
    u0 = torch.tensor(np.sin(disc.x), dtype=dtype, device=device)
    return disc, cfl_step(disc), u0, terminal_integral_cotangent(disc, dtype, device)


def sharded_factories(grid, device):
    """Both sharded factories on this rank's share: {name: run()}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_sharded
    from adjoint_ode_adaptivity_tpu_torch.parallel import shard_along

    c = SHARDED
    disc, dt, u0, lam = sharded_inputs(device, torch.float32)
    u_loc = shard_along(u0, grid, "space", 1).contiguous()
    lam_loc = shard_along(lam, grid, "space", 1).contiguous()
    kw = dict(segment=c["segment"], n_segments=c["n_steps"] // c["segment"], device=device)
    runs = {
        "sharded_blocked": dg_sharded.make_cuda_fwd_adj_estimate_sharded_blocked(
            disc, A, dt, grid, **kw),
        "tiled_grid_sharded": dg_sharded.make_cuda_fwd_adj_estimate_tiled_grid_sharded(
            disc, A, dt, grid, chunks=c["chunks"], **kw),
    }
    return {name: (lambda run=run: run(u_loc, 0.0, lam_loc)) for name, run in runs.items()}


def shard_f64(grid, device):
    """parallel/dg_shard.py's pipeline in float64 on this rank's share."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators
    from adjoint_ode_adaptivity_tpu_torch.parallel import advec_fwd_adj_estimate_sharded, shard_along

    c = SHARD_F64
    disc = mesh(2, c["k"], graded=False)
    ops = advec_operators(disc, a=A, dtype=torch.float64, device=device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float64, device=device)
    lam = terminal_integral_cotangent(disc, torch.float64, device)
    t0 = time.perf_counter()
    res = advec_fwd_adj_estimate_sharded(
        ops, grid, shard_along(u0, grid, "space", 1), shard_along(lam, grid, "space", 1),
        cfl_step(disc), c["n_steps"], segment=c["segment"])
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def sharded_rank(rank, world, store, out_dir):
    """One rank of phase 28 (torch.multiprocessing.spawn): gloo over a
    FileStore, every rank on cuda:0; its outputs go to out_dir/rank{r}.pt."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        grid = make_rank_grid({"space": world})
        device = torch.device("cuda", 0)
        runs = {}
        for name, run in sharded_factories(grid, device).items():
            run()  # warm-up; then one run on the host clock (the ring goes through the host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            runs[name] = ([x.cpu() for x in res], (time.perf_counter() - t0) * 1e3)
        f64, f64_ms = shard_f64(grid, device)
        torch.save({"runs": runs, "f64": [x.cpu() for x in f64], "f64_ms": f64_ms},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase28(device):
    """The sharded pipelines on the card: world 1 in this process, world 2
    in two spawned ranks (gloo, both on cuda:0), bit-equal to the
    single-process tiled pipeline; dg_shard in float64 against the
    single-device estimate."""
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import advec_fwd_adj_estimate
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.march.advec import advec_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_tiled
    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    c = SHARDED
    n_seg = c["n_steps"] // c["segment"]
    disc, dt, u0, lam = sharded_inputs(device, torch.float32)
    tiled = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, A, dt, segment=c["segment"], n_segments=n_seg, chunks=c["chunks"], device=device)
    want = tiled(u0, 0.0, lam)
    prod = (lam.double() * want[0].double())
    j_ref, j_abs = float(prod.sum()), float(prod.abs().sum())

    def check(world, name, got, timing):
        same = [bool(torch.equal(g.to(device), w)) for g, w in zip(got[:3], want)]
        line = (f"world {world} {name} K={c['k']} N=2 segment={c['segment']} steps={c['n_steps']}: "
                f"{timing}; u_final, lam0, eta bit-equal {same}")
        if len(got) == 4:
            share = c["k"] // world
            j_bound = (disc.np_ * share + world) * EPS32 * j_abs
            line += (f"; J {float(got[3]):+.9e} vs Σλu {j_ref:+.9e} (|d| "
                     f"{abs(float(got[3]) - j_ref):.3e}, bound (Np·L + D)·ε·Σ|λu| {j_bound:.3e})")
            assert abs(float(got[3]) - j_ref) <= j_bound, name
        say("28", line)
        assert all(same), f"world {world} {name}: not the single-process tiled pipeline's bits"

    runs = sharded_factories(make_rank_grid(), device)
    dg_tiled.reset_launch_counts()
    out = {name: run() for name, run in runs.items()}
    torch.cuda.synchronize()
    say("28", f"world 1 launches (one run of each factory): KT1 {dg_tiled.tiled_fwd_seg.launches}, "
              f"KT2 {dg_tiled.tiled_rev_seg.launches} (one per segment and run)")
    assert dg_tiled.tiled_fwd_seg.launches == dg_tiled.tiled_rev_seg.launches == 2 * n_seg
    turns = in_turns({"tiled": lambda: out.update(tiled=tiled(u0, 0.0, lam)),
                      **{name: (lambda name=name: out.update({name: runs[name]()})) for name in runs}})
    ms_tiled = statistics.mean(turns["tiled"])
    for name in runs:
        ms = statistics.mean(turns[name])
        check(1, name, out[name], f"{ms:.3f} ms against the single-process tiled pipeline's "
                                  f"{ms_tiled:.3f} ms, sharded/tiled {ms / ms_tiled:.3f} (in turns "
                                  f"tiled, {', '.join(runs)} and back, median of 5 each: {name} "
                                  f"{turns[name][0]:.3f} / {turns[name][1]:.3f}, tiled "
                                  f"{turns['tiled'][0]:.3f} / {turns['tiled'][1]:.3f} ms)")

    world = c["world"]
    tmp = ROOT / "build" / f"chip_smoke_ranks.{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(world, str(tmp / "store"), str(tmp)), nprocs=world, join=True)
        wall = time.perf_counter() - t0
        parts = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("28", f"world {world}: two ranks spawned (gloo over a FileStore, both on cuda:0), "
              f"wall {wall:.1f} s")
    for name in parts[0]["runs"]:
        res = [p["runs"][name][0] for p in parts]
        got = [torch.cat([r[i] for r in res], dim=-1) for i in range(3)]
        if len(res[0]) == 4:
            js = [float(r[3]) for r in res]
            assert js[0] == js[1], js
            got.append(res[0][3])
        check(world, name, got, f"{max(p['runs'][name][1] for p in parts):.3f} ms on the slower "
                                f"rank (host clock, one warm run; the two ranks share the card)")

    s = SHARD_F64
    disc = mesh(2, s["k"], graded=False)
    ops = advec_operators(disc, a=A, dtype=torch.float64, device=device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float64, device=device)
    lam = terminal_integral_cotangent(disc, torch.float64, device)
    t0 = time.perf_counter()
    ref = advec_fwd_adj_estimate(ops, disc, u0, cfl_step(disc), s["n_steps"], segment=s["segment"],
                                 lam_end=lam)
    torch.cuda.synchronize()
    ms_ref = (time.perf_counter() - t0) * 1e3
    got = [torch.cat([p["f64"][i] for p in parts], dim=-1).to(device) for i in range(3)]
    rel = []
    for g, w in zip(got, ref[:3]):
        floor = 1e-12 * float(w.abs().max())  # an entry near 0 keeps the largest's roundoff
        rel.append(float(((g - w).abs() - floor).clamp(min=0).div(w.abs()).nan_to_num().max()))
    # J = Σλu cancels to ~0 here: its error is held against Σ|λ·u|
    dj = abs(float(parts[0]["f64"][3]) - float(ref.j_value)) / float((lam * ref.u_final).abs().sum())
    say("28", f"dg_shard float64 world {world} K={s['k']} N=2 steps={s['n_steps']} segment "
              f"{s['segment']}: {max(p['f64_ms'] for p in parts):.1f} ms per rank against the "
              f"single-device estimate's {ms_ref:.1f} ms; relative error past a 1e-12·max floor "
              f"u_final {rel[0]:.3e} lam0 {rel[1]:.3e} eta {rel[2]:.3e}, J {dj:.3e} of Σ|λu| (limit 1e-10)")
    assert max(rel) <= 1e-10 and dj <= 1e-10


# K2's widest-window plans (s_f, threads) measured beside the wrappers'
# SM-balanced choice at the headline and at a small mesh (the adaptive
# study's K = 512, B = 1), each with the plans' cost model's time
FUSED_PLANS = ((4, 512), (8, 512), (4, 1024), (8, 1024))
FUSED_SMALL = dict(k=512, b=1, n_steps=2048)
# bench.py's batched row with checkpoint segments 4 (tools/tpu_smoke.py:143-161)
# and 64 (the adaptive loop's pick_chunk at 2048 steps)
FUSED_SEGMENTS = (4, 64)


def kernel_registers(log: str, names) -> list:
    """Registers, stack and spills that ``nvcc -Xptxas -v`` reported for the
    instances of the kernels ``names``, one string an instance, sorted."""
    out, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            mangled = ln.split(" for ", 1)[1].strip()
            name = mangled if any(k in mangled for k in names) else None
            frame = ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            out.append(f"{short_name(name, names)}: {ln.split('Used ', 1)[1].split(',')[0]}, "
                       f"{frame}")
            name = None
    return sorted(out)


def short_name(mangled: str, names) -> str:
    """A template instance's readable name, e.g. burgers_fused<float, 4,
    1024> from its mangled one."""
    import re

    for k in names:
        m = re.search(rf"{k}I([fd]?)((?:Li\d+E)*)E", mangled)
        if m:
            args = ({"f": ["float"], "d": ["double"]}.get(m.group(1), [])
                    + re.findall(r"Li(\d+)E", m.group(2)))
            return f"{k}<{', '.join(args)}>"
        if k in mangled:
            return k
    return mangled


def k2_plans(label, traj, uf, lam, ops, sms):
    """K2 on the wrappers' plan and on FUSED_PLANS' widest windows, timed in
    turns on the same (n_steps, Np, B, K) trajectory, each beside the plans'
    cost model; every plan gives the wrappers' plan's bits. Returns the
    wrappers' plan's mean time."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    n_steps, np_, b, k = traj.shape
    plans = {"wrappers' plan": dg_rhs.stored_plan(k, b, np_, n_steps, sms),
             **{f"s_f={st} {th} threads widest": dg_rhs.fused_plan(k, st, th)
                for st, th in FUSED_PLANS}}
    out, counts = {}, {}

    def k2_on(key, plan):
        def run():
            lam0, eta, counts[key] = dg_rhs._k2_launch(traj, uf, lam, 0.0, ops, plan)
            out[key] = (lam0, eta)

        return run

    turns = in_turns({key: k2_on(key, plan) for key, plan in plans.items()})
    ref = out["wrappers' plan"]
    bound = advec_bounds(np_, b * k, n_steps)["tiled_rev_seg"][0]
    for key, plan in plans.items():
        ms = statistics.mean(turns[key])
        model = dg_rhs._fused_cost(k, b, n_steps, counts[key], plan, sms) / 1e3
        same = all(bool(torch.equal(x, y)) for x, y in zip(out[key], ref))
        say("29", f"{label} K={k} B={b} steps={n_steps} K2 {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads, {plan.n_tiles}x{b} CTAs, "
                  f"ghost 2W/L {2 * plan.ghost / plan.tile:.1%}; {ms:.3f} ms (model {model:.3f}; "
                  f"in turns, median of 5 each: {turns[key][0]:.3f} / {turns[key][1]:.3f}), "
                  f"{counts[key]} CUDA launches, {bound / ms:.2%} of the {bound:.4f} ms bound; bits "
                  f"equal to the wrappers' plan: {same}")
        assert same and counts[key] == -(-n_steps // plan.segment)
    return statistics.mean(turns["wrappers' plan"])


def phase29(device, lib):
    """K2 and K2r fused over s_f steps a launch: their times, CUDA launches
    and bound shares at the headline and at bench.py's batched row (segments
    4 and 64), the widest-window plans beside the wrappers' choice at every
    row, the stored pipeline against KT1 + KT2 at phase 24's rows, and the
    kernels' registers and spills."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    regs = kernel_registers(lib.build_log, ("rev_fused", "fwd_fused", "adj_fused"))
    say("29", f"ptxas -v for the fused kernels ({len(regs)} instances): {'; '.join(regs)}")
    assert regs, "no fused kernel instance in the build log"
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    # (a) the headline: K2 on each plan in turns, then through its wrapper
    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    disc = mesh(n_order, k, graded=False)
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    u0 = phased_states(disc, b, device, torch.float32)
    lam = batched_cotangent(disc, b, device, torch.float32)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, n_steps, ops, store_trajectory=True)
    k2_plans("(a) headline", traj, uf, lam, ops, sms)
    out = {}
    ms_k2 = cuda_ms(lambda: out.update(k2=dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)), 5)
    bound_k2 = dg_bounds()["adj_est_stored"][0]
    say("29", f"(a) adj_est_stored at the headline on {sms} SMs: {ms_k2:.3f} ms (median of 5), "
              f"{dg_rhs.adj_est_stored.cuda_launches} CUDA launches a call (was 20 a step: "
              f"{20 * n_steps}), {bound_k2 / ms_k2:.2%} of its {bound_k2:.3f} ms bound")
    assert dg_rhs.adj_est_stored.cuda_launches == -(-n_steps // dg_rhs.stored_plan(
        k, b, disc.np_, n_steps, sms).segment)

    # (b) bench.py's batched row through the recompute pipeline's kernel,
    # segments 4 and 64; K2's bits
    for segment in FUSED_SEGMENTS:
        ckpts = traj[::segment].contiguous()
        ms = cuda_ms(lambda: out.update(k2r=dg_rhs.adj_est_recompute(ckpts, lam, 0.0, segment, ops)), 5)
        n_cuda = dg_rhs.adj_est_recompute.cuda_launches
        plan = dg_rhs.recompute_plan(k, b, disc.np_, segment, n_steps, sms)
        bound = advec_bounds(disc.np_, b * k, n_steps, n_steps // segment)["adj_est_recompute"][0]
        same = all(bool(torch.equal(x, y)) for x, y in zip(out["k2r"], out["k2"]))
        say("29", f"(b) bench row K2r segment {segment}: {ms:.3f} ms (median of 5), {n_cuda} CUDA "
                  f"launches a call (s_f={plan.segment}, {plan.n_tiles}x{b} CTAs of {plan.tile} + "
                  f"2x{plan.ghost}; was 25 a step: {25 * n_steps}), {bound / ms:.2%} of the "
                  f"{bound:.3f} ms bound; lam0, eta bit-equal to K2: {same}")
        assert same and n_cuda <= 2 * -(-n_steps // plan.segment)
    del traj, uf, out, ckpts
    torch.cuda.empty_cache()

    # (c) phase 24's rows at B = 1 on a uniform mesh: the stored pipeline
    # (K1 + fused K2) against KT1 + KT2 in turns, K2 against KT2 alone (the
    # same kernel through the tiled wrapper), and K2's plans on KT1's
    # trajectory
    for k, seg, chunks, n_steps in TILED_ROWS:
        disc = startup_1d(2, 0.0, 2 * np.pi, k)
        dt = cfl_step(disc)
        ops = dg_rhs.kernel_ops(disc, A, dt, device)
        u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
        lam = terminal_integral_cotangent(disc, torch.float32, device)
        stored = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, n_steps, device)
        tiled = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
            disc, A, dt, segment=seg, n_segments=n_steps // seg, chunks=chunks, device=device)
        out = {}
        turns = in_turns({"K1+K2": lambda: out.update(s=stored(u0, 0.0, lam)),
                          "KT1+KT2": lambda: out.update(t=tiled(u0, 0.0, lam))})
        same = [bool(torch.equal(x, y)) for x, y in zip(out["s"], out["t"])]
        traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, n_steps // seg, tiled.plan, ops)
        t3, u3, l3 = traj[:, :, None], uf[:, None], lam[:, None]
        alone = in_turns({"K2": lambda: out.update(k2=dg_rhs.adj_est_stored(t3, u3, l3, 0.0, ops)),
                          "KT2": lambda: out.update(kt2=dg_tiled.tiled_rev_seg(
                              traj, uf, lam, 0.0, tiled.plan, ops))})
        same += [bool(torch.equal(out["k2"][0][:, 0], out["kt2"][0])),
                 bool(torch.equal(out["k2"][1][0], out["kt2"][1]))]
        ms = {name: statistics.mean(t) for name, t in {**turns, **alone}.items()}
        plan = dg_rhs.stored_plan(k, 1, disc.np_, n_steps, sms)
        bound = advec_bounds(disc.np_, k, n_steps)["tiled_rev_seg"][0]
        say("29", f"(c) K={k} N=2 B=1 steps={n_steps}: K1+K2 {ms['K1+K2']:.3f} ms against KT1+KT2 "
                  f"{ms['KT1+KT2']:.3f} ms (ratio {ms['K1+K2'] / ms['KT1+KT2']:.3f}; in turns, median "
                  f"of 5 each: {turns['K1+K2'][0]:.3f} / {turns['K1+K2'][1]:.3f}, "
                  f"{turns['KT1+KT2'][0]:.3f} / {turns['KT1+KT2'][1]:.3f}); K2 alone {ms['K2']:.3f} ms "
                  f"({alone['K2'][0]:.3f} / {alone['K2'][1]:.3f}; "
                  f"{dg_rhs.adj_est_stored.cuda_launches} CUDA launches, {plan.n_tiles} CTAs of "
                  f"{plan.tile} + 2x{plan.ghost}, {bound / ms['K2']:.2%} of the {bound:.3f} ms bound) "
                  f"against KT2 {ms['KT2']:.3f} ms (K2's kernel through the tiled wrapper, "
                  f"{dg_tiled.tiled_rev_seg.cuda_launches} CUDA launches; "
                  f"{bound / ms['KT2']:.2%}); "
                  f"u_final, lam0, eta and K2 vs KT2 bit-equal: {same}")
        assert all(same), f"K={k}: the fused K2 is not the tiled pipeline's bits"
        k2_plans("(c)", t3, u3, l3, ops, sms)
        del out, traj, uf, t3
        torch.cuda.empty_cache()

    # (d) a small mesh (the adaptive study's K, B = 1): the plans' floor
    c = FUSED_SMALL
    disc = mesh(n_order, c["k"], graded=False)
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    u0 = phased_states(disc, c["b"], device, torch.float32)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, c["n_steps"], ops, store_trajectory=True)
    k2_plans("(d) small mesh", traj, uf, batched_cotangent(disc, c["b"], device, torch.float32),
             ops, sms)


# K1's widest-window plans (s_f, threads) measured beside the wrappers' choice
# at the four rows it serves, each with the plans' cost model
FWD_PLANS = ((8, 512), (16, 512), (16, 1024), (32, 1024))
# revolve's advance at bench.py's revolve row: one 128-step unit from a host t0
FWD_ADVANCE = dict(k=REVOLVE_BENCH["k"], n_steps=REVOLVE_BENCH["unit"], t0=0.5)


def k1_bound(np_, b, k, n_steps, n_stored):
    """K1's least time: u0 read and u_final written once, the geometry read
    once, n_stored states written; 5 stages a step (see dg_bounds)."""
    state = 4 * np_ * b * k
    return bound((2 + n_stored) * state + 3 * 4 * k, n_steps * 5 * stage_ops(np_) * b * k)


def k1_plans(label, u0, t0, n_steps, store_every, ops, sms):
    """K1 through its wrapper, on the wrappers' plan and on FWD_PLANS'
    widest windows, timed in turns on the same (Np, B, K) u0, each beside the
    plans' cost model and K1's bound; every plan's stored states and u_final
    are the wrapper's bits. Returns the wrapper's mean ms."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, load_library

    np_, b, k = u0.shape
    plans = {"wrappers' plan": dg_rhs.forward_plan(k, b, np_, n_steps, store_every, sms),
             **{f"s_f={min(st, n_steps)} {th} threads widest":
                dg_rhs.fwd_fused_plan(k, min(st, n_steps), th) for st, th in FWD_PLANS}}
    slots = -(-n_steps // store_every) if store_every else 0
    lib = load_library()
    out, counts = {}, {}

    def wrapper():
        out.pop("wrapper", None)  # the last call's states go before the next allocates
        if store_every is None:
            out["wrapper"] = dg_rhs.fwd_march(u0, t0, n_steps, ops)
        elif store_every == 1:
            out["wrapper"] = dg_rhs.fwd_march(u0, t0, n_steps, ops, store_trajectory=True)
        else:
            out["wrapper"] = dg_rhs.fwd_march_ckpt(u0, t0, n_steps, store_every, ops)

    def k1_on(key, plan):
        store = torch.empty((slots, *u0.shape), device=u0.device) if store_every else None

        def run():
            uf, counts[key] = dg_rhs._k1_launch(lib, u0, t0, n_steps, store, store_every or 1,
                                                ops, plan)
            out[key] = (store, uf)

        return run

    turns = in_turns({"wrapper": wrapper, **{key: k1_on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = (dg_rhs.fwd_march if store_every in (None, 1)
                         else dg_rhs.fwd_march_ckpt).cuda_launches
    ref = out["wrapper"]
    b_ms, b_by = k1_bound(np_, b, k, n_steps, slots)
    for key, plan in {"wrapper": plans["wrappers' plan"], **plans}.items():
        ms = statistics.mean(turns[key])
        model = dg_rhs._fwd_cost(k, b, np_, n_steps, store_every, plan, sms) / 1e3
        same = torch.equal(out[key][1], ref[1]) and (
            store_every is None or torch.equal(out[key][0], ref[0]))
        say("30", f"{label} K={k} B={b} Np={np_} steps={n_steps} store_every={store_every} K1 "
                  f"{key}: s_f={plan.segment} W={plan.ghost} L={plan.tile} {plan.threads} "
                  f"threads, {plan.n_tiles}x{b} CTAs, ghost 2W/L {2 * plan.ghost / plan.tile:.1%}; "
                  f"{ms:.4f} ms (model {model:.4f}; in turns, median of 5 each: "
                  f"{turns[key][0]:.4f} / {turns[key][1]:.4f}), {counts[key]} CUDA launches, "
                  f"{b_ms / ms:.2%} of the {b_ms:.5f} ms bound ({b_by}); stored states and "
                  f"u_final bit-equal to the wrapper's: {same}")
        assert same and counts[key] == -(-n_steps // plan.segment), key
    return statistics.mean(turns["wrapper"])


def phase30(device, lib):
    """K1 fused over s_f steps a launch at the four rows it serves: its
    plans, times, CUDA launches and bound shares, the plans' bits, and the
    kernel's registers and spills."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.advec import cfl_dt
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    regs = kernel_registers(lib.build_log, ("fwd_fused",))
    say("30", f"ptxas -v for K1's kernel ({len(regs)} instances): {'; '.join(regs)}")
    assert regs, "no fwd_fused instance in the build log"
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    # (a) the trajectory at the headline, (b) the checkpoints at bench.py's
    # batched row (the same shapes), segments 4 and 64
    n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
    disc = mesh(n_order, k, graded=False)
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    u0 = phased_states(disc, b, device, torch.float32)
    for label, every in (("(a) headline trajectory", 1),
                         *((f"(b) bench row checkpoints segment {seg}", seg)
                           for seg in FUSED_SEGMENTS)):
        k1_plans(label, u0, 0.0, n_steps, every, ops, sms)
        torch.cuda.empty_cache()

    # (c) revolve's advance: one unit at K = 10^5, B = 1, from a host t0
    c = FWD_ADVANCE
    disc = mesh(2, c["k"], graded=False)
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    u1 = torch.tensor(np.sin(disc.x)[:, None, :], dtype=torch.float32, device=device)
    k1_plans("(c) revolve's advance", u1, c["t0"], c["n_steps"], None, ops, sms)

    # (d) the advec_dg march (--kernel cuda --k 512: N = 2, T = 2, cfl 0.75)
    disc = startup_1d(2, 0.0, 2 * np.pi, 512)
    dt, n_march = cfl_dt(disc, A, 0.75, 2.0)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u1 = torch.tensor(np.sin(disc.x)[:, None, :], dtype=torch.float32, device=device)
    k1_plans("(d) advec_dg march", u1, 0.0, n_march, None, ops, sms)


ADJ_PLANS = ((8, 512), (16, 512), (16, 1024), (32, 1024))


def phase31(device, lib):
    """KA fused over s_f steps a launch at phase 23(d)'s row: the wrapper and
    its plan beside ADJ_PLANS' widest windows, timed in turns, λ0 bit-equal
    across all of them (a gate), each beside the plans' cost model, its CUDA
    launches, the per-warp step constant it implies and its share of KA's
    bound; and the kernel's registers and spills."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    regs = kernel_registers(lib.build_log, ("adj_fused",))
    say("31", f"ptxas -v for KA's kernel ({len(regs)} instances): {'; '.join(regs)}")
    assert regs, "no adj_fused instance in the build log"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k, n_steps = RECOMPUTE["k"], RECOMPUTE["n_steps"]
    disc = mesh(2, k, graded=False)
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    lam = batched_cotangent(disc, 1, device, torch.float32)
    np_ = disc.np_
    plans = {"wrapper's plan": dg_rhs.adjoint_plan(k, 1, np_, n_steps, sms),
             **{f"s_f={st} {th} threads widest": dg_rhs.fwd_fused_plan(k, st, th)
                for st, th in ADJ_PLANS}}
    out, counts = {}, {}

    def wrapper():
        out["wrapper"] = dg_rhs.adj_march(lam, n_steps, ops)

    def ka_on(key, plan):
        def run():
            out[key], counts[key] = dg_rhs._ka_launch(lam, n_steps, ops, plan)

        return run

    turns = in_turns({"wrapper": wrapper, **{key: ka_on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = dg_rhs.adj_march.cuda_launches
    b_ms, b_by = advec_bounds(np_, k, n_steps)["adj_march"]
    for key, plan in {"wrapper": plans["wrapper's plan"], **plans}.items():
        ms = statistics.mean(turns[key])
        launches = -(-n_steps // plan.segment)
        model = dg_rhs._fused_cost(k, 1, n_steps, launches, plan, sms, dg_rhs.ADJ_STEP_WARP_US) / 1e3
        warps = -(-plan.n_tiles // sms) * -(-min(plan.tile + 2 * plan.ghost, k) // 32)
        implied = (ms * 1e3 - launches * dg_rhs.LAUNCH_US) / (n_steps * max(warps, dg_rhs.MIN_WARPS))
        same = torch.equal(out[key], out["wrapper"])
        say("31", f"KA K={k} B=1 Np={np_} steps={n_steps} {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads, {plan.n_tiles} CTAs, ghost "
                  f"2W/L {2 * plan.ghost / plan.tile:.1%}; {ms:.4f} ms (model {model:.4f}, "
                  f"implied {implied:.4f} µs a warp a step; in turns, median of 5 each: "
                  f"{turns[key][0]:.4f} / {turns[key][1]:.4f}), {counts[key]} CUDA launches, "
                  f"{b_ms / ms:.2%} of the {b_ms:.5f} ms bound ({b_by}); lam0 bit-equal to the "
                  f"wrapper's: {same}")
        assert same and counts[key] == launches, key


T2_ROWS = ((512, 2), (8192, 10))  # the recurrent path's minibatch; bench.py's row


def phase32(device, lib, errs):
    """T2 on its thread-block cluster at T2_ROWS: the wrapper and its plan
    beside every other (BM, C) the kernel takes, timed in turns, each within
    dense_kernel_tolerance at its own (BM, C) (a gate), the same hidden-chain
    GEMMs through torch.matmul (FP32, TF32 off) and the share of t2_bound;
    a torch.profiler trace of 20 wrapper calls (the device's busy share, the
    cluster kernel's share of it); the kernels' registers. Returns {row:
    (wrapper ms, GEMMs ms)}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td

    regs = kernel_registers(lib.build_log, ("dense_cluster_kernel", "dense_reduce_kernel"))
    say("32", f"ptxas -v for T2's kernels: {'; '.join(regs)}")
    assert any(r.startswith("dense_cluster_kernel") for r in regs)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sizes = NN_T2["sizes"]
    rows = {}
    for b, s_steps in T2_ROWS:
        params, dt, u0, tr = nn_t2_inputs(device, s_steps)
        u0, tr = u0[:b].contiguous(), tr[:b].contiguous()
        theta = td.pack_dense(params, sizes, device)
        mine = td.dense_plan(sizes, b, sms)
        plans = {(bm, c): td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c))
                 for bm, c in td._feasible(sizes)}
        for key, plan in plans.items():
            t2_case(f"B={b} S={s_steps} plan {key}", device, errs, params, dt, u0, tr, "32", plan)
        a = torch.rand((b, sizes[0]), device=device)
        w = torch.rand(sizes, device=device)
        dz = torch.rand((b, sizes[1]), device=device)

        def gemms():
            for _ in range(s_steps):
                a @ w, a @ w, a.T @ dz, dz @ w.T  # forward, recompute, ∂W, ∂a

        def on(plan):
            return lambda: td._t2_launch(theta, sizes, dt, u0, tr, plan)

        turns = in_turns({"wrapper": lambda: td.dense_epoch_grad(theta, sizes, dt, u0, tr),
                          **{key: on(plan) for key, plan in plans.items()},
                          "torch.matmul GEMMs": gemms})
        b_ms, b_by, n_ops = t2_bound(s_steps, sizes, b)
        for key in turns:
            ms = statistics.mean(turns[key])
            plan = mine if key == "wrapper" else plans.get(key)
            what = (f"(BM, C) = ({plan.block_members}, {plan.cluster}), {plan.n_tiles} clusters, "
                    f"{plan.n_tiles * plan.cluster} CTAs of {plan.smem_bytes} B shared memory"
                    if plan else "the same hidden-chain products, FP32, TF32 off (a yardstick)")
            say("32", f"T2 {sizes} B={b} S={s_steps} {key}: {what}; {ms:.4f} ms (in turns, median "
                      f"of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}); "
                      f"{n_ops / (ms / 1e3) / 1e12:.2f} TFLOP/s, {b_ms / ms:.2%} of the "
                      f"{b_ms:.5f} ms bound ({b_by})")
        # where a wrapper call's time goes: 20 calls under torch.profiler
        study_trace(lambda: [td.dense_epoch_grad(theta, sizes, dt, u0, tr) for _ in range(20)],
                    "dense_cluster_kernel", phase="32")
        wrapper_ms = statistics.mean(turns["wrapper"])
        gemm_ms = statistics.mean(turns["torch.matmul GEMMs"])
        say("32", f"T2 B={b} S={s_steps}: the wrapper's plan ({mine.block_members}, "
                  f"{mine.cluster}) at {wrapper_ms / gemm_ms:.3f}x the torch.matmul GEMMs; fastest "
                  f"plan {min((k for k in turns if k in plans), key=lambda k: statistics.mean(turns[k]))}")
        rows[(b, s_steps)] = (wrapper_ms, gemm_ms)

    return rows


# B1's rows: burgers_dg's shape (its defaults: K = 48, N = 4, dt 2e-4, T =
# 1.5, ΠN; u0 = 0.5 + sin x) and bench.py's row at B = 8 and 1
B1_ROWS = (dict(label="burgers_dg's shape", n_order=4, k=48, b=1, n_steps=7500, dt=2e-4),
           dict(label="bench row", n_order=2, k=10_000, b=8, n_steps=2048, dt=None),
           dict(label="bench row", n_order=2, k=10_000, b=1, n_steps=2048, dt=None))
# B1's widest plans (s_f, threads) timed beside the wrapper's, and the ring
# where a CTA holds the mesh
B1_PLANS = ((2, 512), (4, 512), (8, 512), (16, 512), (4, 1024), (8, 1024), (16, 1024))
T1_STEPS = (2, 5, 10)  # the variable_params path's S = 2-5, bench.py's S = 10


def b1_plans(row, device, sms):
    """B1 through its wrapper, on the wrapper's plan, on B1_PLANS' widest
    windows and on the ring where a CTA holds the mesh, timed in turns on
    the same float32 state, each beside the plans' cost model and B1's
    bound; every plan's output is the wrapper's bits (a gate). Returns the
    wrapper's mean ms."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb

    n, k, b, n_steps = row["n_order"], row["k"], row["b"], row["n_steps"]
    disc = startup_1d(n, 0.0, 2 * np.pi, k)
    dt = row["dt"] or BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, dt, "n", device)
    if k == 48:
        u0 = torch.tensor((0.5 + np.sin(disc.x))[:, None, :], dtype=torch.float32, device=device)
    else:
        u0 = burgers_ics(disc, b, device, torch.float32)
    mine = cb.burgers_plan(k, b, tab.np_, n_steps, "n", False, sms)
    plans = {}
    for st, th in B1_PLANS:
        if th in cb._threads_for(False, tab.np_):
            plans[f"s_f={min(st, n_steps)} {th} threads widest"] = cb.burgers_fused_plan(
                k, min(st, n_steps), th)
    for th in cb._threads_for(False, tab.np_):
        if k <= th:
            plans[f"ring {th} threads"] = cb.BurgersPlan(n_steps, 0, k, 1, th)
            break
    out, counts = {}, {}

    def wrapper():
        out["wrapper"] = cb.burgers_march(u0, n_steps, tab)

    def on(key, plan):
        def run():
            out[key], counts[key] = cb._b1_launch(u0, n_steps, tab, plan)

        return run

    turns = in_turns({"wrapper": wrapper, **{key: on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = cb.burgers_march.cuda_launches
    b_ms, b_by = burgers_bound(n, k, b, n_steps)
    for key, plan in {"wrapper": mine, **plans}.items():
        ms = statistics.mean(turns[key])
        model = cb._cost(k, b, tab.np_, n_steps, plan, sms) / 1e3
        same = torch.equal(out[key], out["wrapper"])
        ghost = (f"W={plan.ghost} L={plan.tile}, ghost 2W/L {2 * plan.ghost / plan.tile:.1%}"
                 if not cb.is_ring(k, plan) else "the ring, no ghosts")
        say("33", f"B1 {row['label']} K={k} N={n} B={b} steps={n_steps} {key}: s_f="
                  f"{plan.segment} {ghost}, {plan.threads} threads, {plan.n_tiles}x{b} CTAs of "
                  f"{-(-cb.window_of(k, plan) // 32) * 32}; {ms:.4f} ms (model {model:.4f}; in "
                  f"turns, median of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}), "
                  f"{counts[key]} CUDA launches, {b_ms / ms:.3%} of the {b_ms:.5f} ms bound "
                  f"({b_by}); bit-equal to the wrapper's: {same}")
        assert same and counts[key] == -(-n_steps // plan.segment), key
    return statistics.mean(turns["wrapper"])


def t1_plans(s_steps, device, errs, sms):
    """T1 at F = 500, B = 8192 and S steps: the wrapper and every member
    tile the kernel takes, timed in turns, each within
    resblock_kernel_tolerance at its own tile's reduction (a gate), beside
    t1_bound. Returns the wrapper's mean ms."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    packed, dt, u0, tg = nn_t1_inputs(device, s=s_steps)
    b, f = u0.shape[0], NN_T1["f"]
    inv_b = 1.0 / b
    mine = tf.resblock_plan(b, sms)
    plans = {bm: tf.ResblockPlan(bm, -(-b // bm)) for bm in tf.TILE_MEMBERS}
    l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), dt.double(), u0.double(),
                                            tg.double(), inv_b=inv_b)
    out = {}

    def on(bm, plan):
        def run():
            out[bm] = tf._t1_launch(packed, dt, u0, tg, None, None, None, inv_b, False, plan)

        return run

    turns = in_turns({"wrapper": lambda: tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b),
                      **{bm: on(bm, plan) for bm, plan in plans.items()}})
    b_ms, b_by, n_ops = t1_bound(s_steps, f, b)
    for key in turns:
        plan = mine if key == "wrapper" else plans[key]
        ms = statistics.mean(turns[key])
        line = (f"T1 S={s_steps} F={f} B={b} {'wrapper' if key == 'wrapper' else 'tile'} "
                f"(BM, tiles) = ({plan.block_members}, {plan.n_tiles}): {ms:.4f} ms (in turns, "
                f"median of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}), "
                f"{n_ops / (ms / 1e3) / 1e12:.2f} TFLOP/s, {b_ms / ms:.2%} of the {b_ms:.5f} ms "
                f"bound ({b_by})")
        if key != "wrapper":
            loss, g = out[key]
            tol = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b,
                                               reduce_terms=tf.reduce_terms_of(plan))
            d = (g.double() - g64).abs()
            inside = bool((d <= tol["grads"]).all()) and abs(float(loss) - float(l64)) <= tol["loss"]
            line += (f"; within resblock_kernel_tolerance at reduce_terms "
                     f"{tf.reduce_terms_of(plan)}: {inside} (worst "
                     f"{float((d / tol['grads'].clamp_min(1e-300)).max()):.2%} of its bound)")
            assert inside, f"T1 tile {key} leaves its tolerance"
            errs["resblock_epoch_grad"] = max(errs["resblock_epoch_grad"], float(d.max()))
        say("33", line)
    return statistics.mean(turns["wrapper"])


def phase33(device, lib, errs):
    """B1 fused over s_f steps a launch and T1 split over neurons within a
    member tile: the kernels' registers and spills; (a) B1's plans at its
    rows, in turns, every plan the wrapper's bits (float64 against the
    untiled plain version: phase 19); (b) T1 at S = 2, 5 and 10 on every
    member tile, in turns, each within its tolerance; (c) a torch.profiler
    trace of 20 T1 calls at S = 2. Returns {name: wrapper ms} of the
    rows."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    regs = kernel_registers(lib.build_log, ("burgers_fused", "resblock_tile_kernel",
                                            "resblock_reduce_kernel"))
    say("33", f"ptxas -v for B1's and T1's kernels: {'; '.join(regs)}")
    assert any("burgers_fused" in r for r in regs) and any("resblock_tile" in r for r in regs)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {}
    for row in B1_ROWS:
        rows[f"B1 {row['label']} B={row['b']}"] = b1_plans(row, device, sms)
    for s_steps in T1_STEPS:
        rows[f"T1 S={s_steps}"] = t1_plans(s_steps, device, errs, sms)
    # where a T1 call's time goes at the path's S = 2: 20 back-to-back calls
    # on the host clock; the same 20 queued behind a device-side sleep, so
    # that CUDA events time the device alone; then under torch.profiler for
    # the split between the two kernels (late in a long process it may
    # record few or none of the launches)
    packed, dt, u0, tg = nn_t1_inputs(device, s=2)
    inv_b = 1.0 / u0.shape[0]

    def calls():
        for _ in range(20):
            tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b)

    calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / 20 * 1e3
    device_ms = queued_ms(lambda: tf.resblock_epoch_grad(packed, dt, u0, tg, inv_b=inv_b))
    seen = study_trace(calls, "resblock_tile_kernel", phase="33", also=("resblock_reduce_kernel",))
    split = "; ".join(f"{k} {ms / n:.4f} ms a launch" for k, (ms, n) in seen.items() if n)
    say("33", f"T1 S=2 F=500 B=8192, 20 back-to-back wrapper calls: {per_call:.4f} ms a call on "
              f"the host clock, {device_ms:.4f} ms a call on the device (the calls queued behind "
              f"a sleep, CUDA events): the device busy {device_ms / per_call:.1%} of the calls' "
              f"wall, the host's side {per_call - device_ms:.4f} ms a call beyond it; the "
              f"profiler's split: {split or 'no launch recorded'}")
    return rows


# KM2's small shapes (phase 26's meshes, B = 8, a step 10x the CFL-free
# 2e-4 so that η sits above roundoff) held to the plain version's bits on
# every plan, with narrow tiles so that windows cut members
KM2_SMALL = ((1, 24, 2e-3), (2, 64, 2e-3), (7, 24, 5e-4))
HP_LANES = (1, 4, 8, 16, 32)  # 1: one lane a member, the design H1 replaced


def km2_candidates(k, b, np_, n_steps, sms):
    """The wrapper's plan and, for each (s_f, CTA size) that km_rev_plan
    searches, the tiling its cost model rates cheapest there."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    plans = {"wrapper's plan": dg_mxu.km_rev_plan(k, b, np_, n_steps, sms)}
    for st in sorted({min(x, n_steps) for x in dg_rhs.FUSED_CANDIDATE_STEPS}):
        for th in dg_rhs.FUSED_THREADS if np_ <= 6 else dg_rhs.FUSED_THREADS[:1]:
            plans[f"s_f={st} {th} threads"] = dg_rhs._cheapest(
                dg_rhs._tilings(k, b, sms, dg_rhs.fused_plan(k, st, th)),
                lambda plan: dg_rhs._fused_cost(k, b, n_steps, -(-n_steps // plan.segment), plan,
                                                sms, dg_mxu.km_step_warp_us(np_)))
    return plans


def km2_plans(n_order, seg, n_steps, device, sms, errs):
    """KM2 through its wrapper and on every plan of km2_candidates at one
    MXU row (K = 10^4, B = 8), timed in turns on KM1's trajectory, each with
    its CUDA launches, the cost model (and the KM_STEP_WARP_US it implies)
    and its share of mxu_bounds; every plan's output the wrapper's bits, and
    the wrapper's the plain version's (a gate). Returns the wrapper's mean
    ms."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    disc = mesh(n_order, 10_000, graded=False)
    km, _, u0, lam = mxu_run(disc, cfl_step(disc), seg, n_steps, device)
    ops = km.ops
    flat = (disc.np_, ops.n)
    lam = lam.reshape(flat)
    traj, uf = dg_mxu.km_fwd_traj(u0.reshape(flat), 0.0, ops)
    plans = km2_candidates(ops.k, ops.b, disc.np_, n_steps, sms)
    out, counts = {}, {}

    def on(key, plan):
        def run():
            *out[key], counts[key] = dg_mxu._km2_launch(traj, uf, lam, 0.0, ops, plan)

        return run

    def wrapper():
        out["wrapper"] = dg_mxu.km_adj_est(traj, uf, lam, 0.0, ops)

    turns = in_turns({"wrapper": wrapper, **{key: on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = dg_mxu.km_adj_est.cuda_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.0, ops)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bits = all(bool(torch.equal(x, y)) for x, y in zip(out["wrapper"], want))
    errs["mxu_adj_est"] = max(errs["mxu_adj_est"], *(float((x - y).abs().max())
                                                    for x, y in zip(out["wrapper"], want)))
    b_ms, b_by = mxu_bounds(disc.np_, ops.n, n_steps)["mxu_adj_est"]
    for key, plan in {"wrapper": plans["wrapper's plan"], **plans}.items():
        ms = statistics.mean(turns[key])
        warps = max(-(-plan.n_tiles * ops.b // sms) * -(-min(plan.tile + 2 * plan.ghost, ops.k)
                                                         // 32), dg_rhs.MIN_WARPS)
        model = dg_rhs._fused_cost(ops.k, ops.b, n_steps, counts[key], plan, sms,
                                   dg_mxu.km_step_warp_us(disc.np_))
        implied = ((ms * 1e3 - counts[key] * dg_rhs.LAUNCH_US)
                   / (n_steps * warps * (2 * disc.np_ ** 2 + 9 * disc.np_ + 4)))
        same = all(bool(torch.equal(x, y)) for x, y in zip(out[key], out["wrapper"]))
        say("34", f"KM2 N={n_order} K=10000 B=8 steps={n_steps} {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads ({plan.n_tiles}x{ops.b} "
                  f"CTAs, {warps} warps on the busiest SM); {ms:.4f} ms (model "
                  f"{model / 1e3:.4f}, implied KM_STEP_WARP_US {implied:.5f}; in turns, median of 5 each: "
                  f"{turns[key][0]:.4f} / {turns[key][1]:.4f}), {counts[key]} CUDA launches, "
                  f"{b_ms / ms:.2%} of the {b_ms:.4f} ms bound ({b_by}); bits equal to the "
                  f"wrapper's: {same}")
        assert same and counts[key] == -(-n_steps // plan.segment), key
    say("34", f"KM2 N={n_order}: the wrapper's lam0 and eta bit-equal to km_adj_est_plain (float32, "
              f"{plain_s:.2f} s on the host clock): {bits}")
    assert bits, f"KM2 at N={n_order}: not the plain version's bits"
    del traj, uf, out
    torch.cuda.empty_cache()
    return statistics.mean(turns["wrapper"])


def km2_small(device, sms):
    """KM2 at KM2_SMALL's shapes (B = 8, 13 steps) on every candidate plan
    and on narrow tiles (L = 5 and 10), each bit-equal to
    km_adj_est_plain."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    n_plans = 0
    for n_order, k, dt in KM2_SMALL:
        disc = mesh(n_order, k, graded=False)
        ops = dg_mxu.mxu_ops(disc, A, dt, 13, 1, 8, device)
        phases = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        u0 = torch.tensor(np.concatenate([np.sin(disc.x + q) for q in phases], 1),
                          dtype=torch.float32, device=device)
        lam = terminal_integral_cotangent(disc, torch.float32, device).repeat(1, 8).contiguous()
        traj, uf = dg_mxu.km_fwd_traj(u0, 0.1, ops)
        want = dg_mxu.km_adj_est_plain(traj, uf, lam, 0.1, ops)
        plans = list(km2_candidates(k, 8, disc.np_, 13, sms).values())
        plans += [dg_rhs.fused_plan(k, 4, 512)._replace(tile=t, n_tiles=-(-k // t)) for t in (5, 10)]
        for plan in plans:
            got = dg_mxu._km2_launch(traj, uf, lam, 0.1, ops, plan)
            assert all(bool(torch.equal(x, y)) for x, y in zip(got[:2], want)), (n_order, plan)
            assert got[2] == -(-13 // plan.segment)
            n_plans += 1
        eta_max = float(want[1].abs().max())
        say("34", f"KM2 N={n_order} (Np={disc.np_}) K={k} B=8 13 steps: lam0 and eta bit-equal to "
                  f"km_adj_est_plain on {len(plans)} plans (max|eta| {eta_max:.3e})")
    return n_plans


def h1_launches(label, case, device, errs):
    """H1 on every (lanes, CTA size) the kernel takes that hp_plan searches
    or HP_LANES lists, timed in turns beside the wrapper, each within
    hp_kernel_tolerance (worst share per output), bit-identical on a repeat,
    with its share of dg_hp_bound. Returns {(lanes, threads): ms}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    run, (times, ns, y0), _, tol = case
    plan = run.plan
    b = y0.shape[0]
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan)
    launches = {(g, th): hm.HpLaunch(g, th) for g in HP_LANES for th in hm.CTA_THREADS}
    out = {}

    def on(key, launch):
        def go():
            out[key] = hm._h1_launch(times, ns, y0, plan, launch)

        return go

    turns = in_turns({"wrapper": lambda: run(times, ns, y0),
                      **{key: on(key, launch) for key, launch in launches.items()}})
    b_ms, b_by = dg_hp_bound(times, ns, plan.newton_iters, plan.fine_offset, plan.mops.rq.shape[0],
                             plan.mops.np_max, plan.adjoint_mode)
    mine = hm.hp_plan(b, plan.mops.np_max, plan.mops.rq.shape[0])
    rows = {}
    for key, launch in launches.items():
        ms = statistics.mean(turns[key])
        first = out[key]
        again = hm._h1_launch(times, ns, y0, plan, launch)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y)) for x, y in zip(first, again))
        e, share = hp_shares(first, want, tol)
        errs["dg_estimate_hp_per_member"] = max(errs["dg_estimate_hp_per_member"], *e.values())
        say("34", f"H1 {label} B={b} {plan.adjoint_mode} G={launch.lanes} {launch.threads} threads"
                  f"{' (the wrapper plan)' if launch == mine else ''}: {ms:.4f} ms (in turns, median "
                  f"of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}), {b_ms / ms:.3%} of the "
                  f"{b_ms:.6f} ms bound ({b_by}); worst share of the per-element tolerance "
                  + " ".join(f"{x} {share[x]:.2%}" for x in share)
                  + f"; a repeat bit-identical: {same}")
        assert same and max(share.values()) <= 1.0, (label, key)
        rows[key] = ms
    say("34", f"H1 {label} B={b} {plan.adjoint_mode}: the wrapper ({mine}) "
              f"{statistics.mean(turns['wrapper']):.4f} ms; fastest "
              f"{min(rows, key=rows.get)} {min(rows.values()):.4f} ms")
    return rows


def phase34(device, lib, errs, hp_cases):
    """KM2 fused over s_f steps a launch and H1 with G lanes a member: the
    kernels' registers and spills (a gate: no km_rev_fused instance
    spills); (a) KM2 at KM2_SMALL's shapes on every plan, bit-equal to the
    plain version; (b) at both MXU_ROWS on every plan, in turns; (d) H1 at
    12(a) and 12(b) in both adjoint modes on every G and CTA size, in
    turns; (e) the B = 512 hp study (phase 14's) in turns on hp_plan's
    launch and on one lane a member, and its trace. (c), KM1+KM2 against
    K1+K2, is phase 36(c)."""
    from unittest import mock

    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    regs = kernel_registers(lib.build_log, ("km_rev_fused", "hp_kernel"))
    say("34", f"ptxas -v for KM2's and H1's kernels ({len(regs)} instances): {'; '.join(regs)}")
    km_regs = [r for r in regs if "km_rev_fused" in r]
    assert km_regs and all("0 bytes spill stores, 0 bytes spill loads" in r for r in km_regs), (
        "a km_rev_fused instance spills")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_small = km2_small(device, sms)
    say("34", f"(a) KM2 bit-equal to its plain version on {n_small} (shape, plan) cases")
    rows = {}
    for n_order, seg, n_steps in MXU_ROWS:
        rows[f"KM2 N={n_order}"] = km2_plans(n_order, seg, n_steps, device, sms, errs)
    for key in (("a", "solve"), ("a", "reconstruct"), ("b", "solve"), ("b", "reconstruct")):
        h1 = h1_launches(f"12({key[0]})", hp_cases[key], device, errs)
        rows[f"H1 12({key[0]}) {key[1]}"] = min(h1.values())
    study = hp_study(device, HP_STUDY["b"], HP_STUDY["seed"])

    def one_lane():
        with mock.patch.object(hm, "hp_plan", lambda b, np_max, nq: hm.HpLaunch(1, 128)):
            study("cuda")

    turns = in_turns({"hp_plan": lambda: study("cuda"), "one lane a member": one_lane}, runs=3)
    its = HP_STUDY["maxit"] + 1
    say("34", f"(e) the hp study B={HP_STUDY['b']} (device loop, {its} iterations) in turns, median "
              f"of 3 each: on hp_plan's launch {statistics.mean(turns['hp_plan']):.3f} ms "
              f"({turns['hp_plan'][0]:.3f} / {turns['hp_plan'][1]:.3f}), on one lane a member "
              f"{statistics.mean(turns['one lane a member']):.3f} ms "
              f"({turns['one lane a member'][0]:.3f} / {turns['one lane a member'][1]:.3f})")
    study_trace(lambda: study("cuda"), "hp_kernel", phase="34")
    return rows


# KT2's plans measured at phase 24's K = 10^6 row: the s_f stored_plan
# searches and MAX_FUSED, on 512- and 1024-thread CTAs
KT2_STEPS = (4, 8, 16)


def kt2_plans(device, sms, errs):
    """KT2 at TILED_ROWS[-1] (K = 10^6, segment 16, 64 steps) on the
    wrapper's plan and, for each (s_f, CTA size) of KT2_STEPS × FUSED_THREADS,
    the tiling the cost model rates cheapest, timed in turns on KT1's
    trajectory; every plan's whole sweep and its sweep one segment a call
    (the global step offset, η carried in) the stored pipeline's bits (a
    gate). Returns {key: ms}."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    k, seg, chunks, n_steps = TILED_ROWS[-1]
    disc = startup_1d(2, 0.0, 2 * np.pi, k)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    tiled = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, A, dt, segment=seg, n_segments=n_steps // seg, chunks=chunks, device=device)
    traj, uf = dg_tiled.tiled_fwd_seg(u0, 0.0, n_steps // seg, tiled.plan, ops)
    want = dg_rhs.adj_est_stored(traj[:, :, None], uf[:, None], lam[:, None], 0.0, ops)
    want = (want[0][:, 0], want[1][0])
    plans = {"wrapper's plan": dg_rhs.stored_plan(k, 1, disc.np_, n_steps, sms)}
    for st in KT2_STEPS:
        for th in dg_rhs.FUSED_THREADS:
            plans[f"s_f={st} {th} threads"] = dg_rhs._cheapest(
                dg_rhs._tilings(k, 1, sms, dg_rhs.fused_plan(k, st, th)),
                lambda plan: dg_rhs._fused_cost(k, 1, n_steps, -(-n_steps // plan.segment), plan,
                                                sms))
    out, counts = {}, {}

    def on(key, plan):
        def run():
            *out[key], counts[key] = dg_tiled._kt2_launch(traj, uf, lam, 0.0, ops, plan)

        return run

    def wrapper():
        out["wrapper"] = dg_tiled.tiled_rev_seg(traj, uf, lam, 0.0, tiled.plan, ops)

    turns = in_turns({"wrapper": wrapper, **{key: on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = dg_tiled.tiled_rev_seg.cuda_launches
    b_ms, b_by = advec_bounds(disc.np_, k, n_steps)["tiled_rev_seg"]
    rows = {}
    for key, plan in {"wrapper": plans["wrapper's plan"], **plans}.items():
        ms = rows[key] = statistics.mean(turns[key])
        warps = max(-(-plan.n_tiles // sms) * -(-min(plan.tile + 2 * plan.ghost, k) // 32),
                    dg_rhs.MIN_WARPS)
        model = dg_rhs._fused_cost(k, 1, n_steps, counts[key], plan, sms) / 1e3
        implied = (ms * 1e3 - counts[key] * dg_rhs.LAUNCH_US) / (n_steps * warps)
        lam_s, eta_s = lam, None
        for si in reversed(range(n_steps // seg)):
            u_end = uf if si == n_steps // seg - 1 else traj[(si + 1) * seg]
            lam_s, eta_s, _ = dg_tiled._kt2_launch(traj[si * seg:(si + 1) * seg], u_end, lam_s,
                                                   0.0, ops, plan, si * seg, eta_s)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y)) for x, y in zip(out[key], want))
        seg_same = bool(torch.equal(lam_s, want[0])) and bool(torch.equal(eta_s, want[1]))
        say("35", f"(a) KT2 K={k} N=2 B=1 steps={n_steps} {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads ({plan.n_tiles} CTAs, "
                  f"{warps} warps on the busiest SM, ghost 2W/L {2 * plan.ghost / plan.tile:.1%}); "
                  f"{ms:.3f} ms (model {model:.3f}, implied STEP_WARP_US {implied:.4f}; in turns, "
                  f"median of 5 each: {turns[key][0]:.3f} / {turns[key][1]:.3f}), {counts[key]} CUDA "
                  f"launches, {b_ms / ms:.2%} of the {b_ms:.3f} ms bound ({b_by}); lam0 and eta "
                  f"the stored pipeline's bits: whole sweep {same}, one {seg}-step segment a call "
                  f"{seg_same}")
        assert same and seg_same and counts[key] == -(-n_steps // plan.segment), key
    say("35", f"(a) KT2: the wrapper {rows['wrapper']:.3f} ms; fastest "
              f"{min(rows, key=rows.get)} {min(rows.values()):.3f} ms")
    del traj, uf, out
    torch.cuda.empty_cache()
    return rows


def d1_plans(label, case, device, errs):
    """D1 on every G of LANES and 32 and every CTA size of CTA_THREADS,
    timed in turns beside the wrapper, each within dg_kernel_tolerance (a
    gate), with its share of dg_slab_bound. Returns {(lanes, threads): ms}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    run, times, y0 = case
    plan = run.plan
    b, k = y0.shape[0], plan.n_elements
    want = ds.dg_estimate_ensemble_plain(times, y0, plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, plan)
    variants = {(g, th): ds.D1Launch(g, th) for g in (*ds.LANES, 32) for th in ds.CTA_THREADS}
    out = {}

    def on(key, launch):
        def go():
            out[key] = ds._d1_launch(times, y0, plan, launch)

        return go

    turns = in_turns({"wrapper": lambda: run(times, y0),
                      **{key: on(key, launch) for key, launch in variants.items()}})
    nqp, nqa = plan.ops_p.phi.shape[0], plan.ops_a.phi.shape[0]
    b_ms, b_by = dg_slab_bound(1, k, b, plan.newton_iters, nqp, nqa, per_member=times.dim() == 2)
    mine = ds.d1_plan(b, plan.ops_p.np_, max(nqp, nqa))
    rows = {}
    for key, launch in variants.items():
        ms = rows[key] = statistics.mean(turns[key])
        e, share = d1_shares(out[key], want, tol)
        errs["dg_estimate_ensemble"] = max(errs["dg_estimate_ensemble"], *e.values())
        mark = " (the wrapper's plan)" if launch == mine else ""
        say("35", f"(b) D1 {label} B={b} K={k} G={launch.lanes} {launch.threads} threads{mark}: "
                  f"{ms:.4f} ms (in turns, "
                  f"median of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}), {b_ms / ms:.3%} "
                  f"of the {b_ms:.6f} ms bound ({b_by}); worst share of the per-element tolerance "
                  + " ".join(f"{x} {share[x]:.2%}" for x in share))
        assert max(share.values()) <= 1.0, (label, key)
    say("35", f"(b) D1 {label} B={b}: the wrapper ({mine}) {statistics.mean(turns['wrapper']):.4f} "
              f"ms; fastest {min(rows, key=rows.get)} {min(rows.values()):.4f} ms")
    return rows


def phase35(device, lib, errs, dg_cases):
    """KT2 on K2's fused windows and D1 with G lanes a member: the kernels'
    registers and spills; (a) KT2's plans at K = 10^6 in turns, every plan
    the stored pipeline's bits whole and one segment a call; (b) D1 on every
    G and CTA size at B = 1024, 16,384 and 102,400, in turns."""
    import torch

    regs = kernel_registers(lib.build_log, ("rev_fused",))
    d1, name = [], None
    for ln in lib.build_log.splitlines():
        if "Function properties for" in ln:
            name = ln.split(" for ", 1)[1].strip()
            name = name if "dg_estimate_kernel" in name else None
            frame = ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            d1.append(f"{instance_name(name)}: {ln.split('Used ', 1)[1].split(',')[0]}, {frame}")
            name = None
    say("35", f"ptxas -v for rev_fused ({len(regs)} instances): {'; '.join(regs)}")
    say("35", f"ptxas -v for dg_estimate_kernel ({len(d1)} instances): {'; '.join(sorted(d1))}")
    assert regs and d1, "no rev_fused or dg_estimate_kernel instance in the build log"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {f"KT2 {key}": ms for key, ms in kt2_plans(device, sms, errs).items()}
    for key, label in (("study", "9(c), B=1024"), ("libm", "9(a)"), ("big", "9(e)")):
        for k2, ms in d1_plans(label, dg_cases[key], device, errs).items():
            rows[f"D1 {label} {k2}"] = ms
    return rows


def km1_plans(k, b, np_, n_steps, sms):
    """KM1's wrapper plan and, for each (s_f, CTA size) that km_fwd_plan
    searches, the plan its cost model rates cheapest there (the untiled CTA
    among them where K fits)."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    plans = {"wrapper's plan": dg_mxu.km_fwd_plan(k, b, np_, n_steps, sms)}
    candidates = list(dg_rhs._window_plans(k, b, n_steps, sms))
    for st in sorted({p.segment for p in candidates}):
        for th in dg_rhs.FUSED_THREADS:
            plans[f"s_f={st} {th} threads"] = dg_rhs._cheapest(
                (p for p in candidates if p.segment == st and p.threads == th),
                lambda plan: dg_mxu.km_fwd_cost(k, b, np_, n_steps, plan, sms))
    return plans


def km1_small(device, sms):
    """KM1 at KM2_SMALL's shapes (B = 8, 13 steps) on every plan
    km_fwd_plan searches and on narrow tiles (L = 5 and 10, s_f 4), each
    bit-equal to km_fwd_traj_plain in ⌈13/s_f⌉ CUDA launches. Returns the
    number of (shape, plan) cases."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    n_plans = 0
    for n_order, k, dt in KM2_SMALL:
        disc = mesh(n_order, k, graded=False)
        ops = dg_mxu.mxu_ops(disc, A, dt, 13, 1, 8, device)
        phases = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        u0 = torch.tensor(np.concatenate([np.sin(disc.x + q) for q in phases], 1),
                          dtype=torch.float32, device=device)
        want = dg_mxu.km_fwd_traj_plain(u0, 0.1, ops)
        plans = list(dg_rhs._window_plans(k, 8, 13, sms))
        plans += [dg_rhs.fwd_fused_plan(k, 4, 512)._replace(tile=t, n_tiles=-(-k // t))
                  for t in (5, 10)]
        for plan in plans:
            *got, n_cuda = dg_mxu._km1_launch(u0, 0.1, ops, plan)
            assert all(bool(torch.equal(x, y)) for x, y in zip(got, want)), (n_order, plan)
            assert n_cuda == -(-13 // plan.segment), (n_cuda, plan)
            n_plans += 1
        say("36", f"(b) KM1 N={n_order} (Np={disc.np_}) K={k} B=8 13 steps: trajectory and u_final "
                  f"bit-equal to km_fwd_traj_plain on {len(plans)} plans")
    return n_plans


def km1_row(n_order, seg, n_steps, device, sms, errs):
    """KM1 through its wrapper and on km1_plans at one MXU row (K = 10^4, B
    = 8), timed in turns, each with its CUDA launches, the cost model (and
    the KM_FWD_STEP_WARP_US it implies) and its share of mxu_bounds; every
    plan's output the wrapper's bits and the wrapper's km_fwd_traj_plain's
    (a gate). Returns {key: ms}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu, dg_rhs

    disc = mesh(n_order, 10_000, graded=False)
    km, _, u0, _ = mxu_run(disc, cfl_step(disc), seg, n_steps, device)
    ops = km.ops
    u0 = u0.reshape(ops.np_, ops.n)
    plans = km1_plans(ops.k, ops.b, disc.np_, n_steps, sms)
    out, counts = {}, {}

    def on(key, plan):
        def run():
            *out[key], counts[key] = dg_mxu._km1_launch(u0, 0.0, ops, plan)

        return run

    def wrapper():
        out["wrapper"] = dg_mxu.km_fwd_traj(u0, 0.0, ops)

    turns = in_turns({"wrapper": wrapper, **{key: on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = dg_mxu.km_fwd_traj.cuda_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dg_mxu.km_fwd_traj_plain(u0, 0.0, ops)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bits = all(bool(torch.equal(x, y)) for x, y in zip(out["wrapper"], want))
    errs["mxu_fwd_traj"] = max(errs["mxu_fwd_traj"], *(float((x - y).abs().max())
                                                      for x, y in zip(out["wrapper"], want)))
    del want
    b_ms, b_by = mxu_bounds(disc.np_, ops.n, n_steps)["mxu_fwd_traj"]
    unit = 2 * disc.np_ ** 2 + 9 * disc.np_ + 4
    rows = {}
    for key, plan in {"wrapper": plans["wrapper's plan"], **plans}.items():
        ms = rows[key] = statistics.mean(turns[key])
        warps = max(-(-plan.n_tiles * ops.b // sms) * -(-min(plan.tile + 2 * plan.ghost, ops.k)
                                                         // 32), dg_rhs.MIN_WARPS)
        model = dg_mxu.km_fwd_cost(ops.k, ops.b, disc.np_, n_steps, plan, sms)
        implied = (ms * 1e3 - counts[key] * dg_rhs.LAUNCH_US) / (n_steps * warps * unit)
        same = all(bool(torch.equal(x, y)) for x, y in zip(out[key], out["wrapper"]))
        say("36", f"(b) KM1 N={n_order} K=10000 B=8 steps={n_steps} {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads ({plan.n_tiles}x{ops.b} "
                  f"CTAs, {warps} warps on the busiest SM); {ms:.4f} ms (model {model / 1e3:.4f}, "
                  f"implied KM_FWD_STEP_WARP_US {implied:.5f}; in turns, median of 5 each: "
                  f"{turns[key][0]:.4f} / {turns[key][1]:.4f}), {counts[key]} CUDA launches, "
                  f"{b_ms / ms:.2%} of the {b_ms:.4f} ms bound ({b_by}); bits equal to the "
                  f"wrapper's: {same}")
        assert same and counts[key] == -(-n_steps // plan.segment), key
    say("36", f"(b) KM1 N={n_order}: the wrapper's trajectory and u_final bit-equal to "
              f"km_fwd_traj_plain (float32, {plain_s:.2f} s on the host clock): {bits}; fastest "
              f"{min(rows, key=rows.get)} {min(rows.values()):.4f} ms")
    assert bits, f"KM1 at N={n_order}: not the plain version's bits"
    del out
    torch.cuda.empty_cache()
    return rows


def f3_launches(device, inp, errs):
    """F3 at phase 6(e)'s shape (B = 1024, 43 steps, rf 4, padded tails),
    sin u in both conventions, on every G of PM_LANES and CTA size of
    PM_THREADS, timed in turns beside the wrapper, each within
    fd_kernel_tolerance (some plain entry above it), padding exactly 0 and
    a repeat bit-identical (a gate), with its share of fd_bounds. Returns
    {(convention, lanes, threads): ms}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    dt_pm, u0_pm = inp["dt_pm"], inp["u0_pm"]
    b, rf = u0_pm.shape[0], FD_STUDY["rf"]
    b_ms, b_by = fd_bounds()["fd_estimate_per_member"]
    rows = {}
    for conv in ("strided", "block"):
        run = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf, conv,
                                                  device=device)
        stats = {}
        want = fe.fd_estimate_per_member_plain(dt_pm, u0_pm, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf)
        above = int((want[0].abs() > tol).sum())
        launches = {(g, th): fe.FdPmLaunch(g, th) for g in fe.PM_LANES for th in fe.PM_THREADS}
        out = {}

        def on(key, launch):
            def go():
                out[key] = fe._f3_launch(dt_pm, u0_pm, run.plan, launch)

            return go

        turns = in_turns({"wrapper": lambda: out.update(wrapper=run(dt_pm, u0_pm)),
                          **{key: on(key, launch) for key, launch in launches.items()}})
        mine = fe.fd_pm_plan(b, FD_PM_STEPS, rf)
        same_all = True
        for key, launch in launches.items():
            ms = rows[(conv, *key)] = statistics.mean(turns[key])
            again = fe._f3_launch(dt_pm, u0_pm, run.plan, launch)
            torch.cuda.synchronize()
            repeat = all(bool(torch.equal(x, y)) for x, y in zip(out[key], again))
            same_all &= all(bool(torch.equal(x, y)) for x, y in zip(out[key], out["wrapper"]))
            e = float((out[key][0] - want[0]).abs().max())
            pad = bool((out[key][0][dt_pm == 0] == 0).all())
            errs["fd_estimate_per_member"] = max(errs["fd_estimate_per_member"], e)
            say("36", f"(d) F3 B={b} {FD_PM_STEPS} steps {conv} G={launch.lanes} {launch.threads} "
                      f"threads{' (the wrapper plan)' if launch == mine else ''}: {ms:.4f} ms (in "
                      f"turns, median of 5 each: {turns[key][0]:.4f} / {turns[key][1]:.4f}), "
                      f"{b_ms / ms:.3%} of the {b_ms:.6f} ms bound ({b_by}); max|err - plain| "
                      f"{e:.3e} (tol {tol:.3e}, {above} plain entries above it); padding 0: "
                      f"{pad}; a repeat bit-identical: {repeat}")
            assert e <= tol and above > 0 and pad and repeat, (conv, key)
        on_device = {f"G={g}": queued_ms(on((g, 128), fe.FdPmLaunch(g, 128))) for g in (1, 32)}
        say("36", f"(d) F3 {conv}: the wrapper ({mine}) {statistics.mean(turns['wrapper']):.4f} ms; "
                  f"fastest {min(launches, key=lambda x: rows[(conv, *x)])} "
                  f"{min(rows[(conv, *x)] for x in launches):.4f} ms; every launch the wrapper's "
                  f"bits: {same_all}; on the device alone (20 calls queued behind a sleep): "
                  f"{', '.join(f'{k} 128 threads {ms:.4f} ms' for k, ms in on_device.items())} "
                  f"a call, the wrapper {queued_ms(lambda: run(dt_pm, u0_pm)):.4f}")
        assert same_all, conv
    return rows


def phase36(device, lib, errs, inp):
    """KM1 fused over s_f steps a launch and F3 with G lanes a member: (a)
    the kernels' registers and spills (a gate: no km_fwd_fused instance
    spills); (b) KM1 at KM2_SMALL's shapes on every plan and at both
    MXU_ROWS on its plans, in turns; (c) KM1+KM2 against K1+K2 at both rows,
    in turns; (d) F3 on every G and CTA size at 6(e)'s shape, in turns; (e)
    the B = 1024 FD study in turns on fd_pm_plan's launch and on one lane a
    member, and its trace."""
    from unittest import mock

    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_mxu
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    regs = kernel_registers(lib.build_log, ("km_fwd_fused",))
    f3, name = [], None
    for ln in lib.build_log.splitlines():
        if "Function properties for" in ln:
            name = ln.split(" for ", 1)[1].strip()
            name = name if "fd_estimate_per_member_kernel" in name else None
            frame = ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            f3.append(f"{instance_name(name)}: {ln.split('Used ', 1)[1].split(',')[0]}, {frame}")
            name = None
    say("36", f"(a) ptxas -v for km_fwd_fused ({len(regs)} instances): {'; '.join(regs)}")
    say("36", f"(a) ptxas -v for fd_estimate_per_member_kernel ({len(f3)} instances): "
              f"{'; '.join(sorted(f3))}")
    assert regs and all("0 bytes spill stores, 0 bytes spill loads" in r for r in regs), (
        "a km_fwd_fused instance spills")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    say("36", f"(b) KM1 bit-equal to its plain version on {km1_small(device, sms)} (shape, plan) "
              f"cases")
    rows = {}
    for n_order, seg, n_steps in MXU_ROWS:
        for key, ms in km1_row(n_order, seg, n_steps, device, sms, errs).items():
            rows[f"KM1 N={n_order} {key}"] = ms
    for n_order, seg, n_steps in MXU_ROWS:
        disc = mesh(n_order, 10_000, graded=False)
        km, k12, u0, lam = mxu_run(disc, cfl_step(disc), seg, n_steps, device)
        out = {}
        turns = in_turns({"K1+K2": lambda: out.update(k12=k12(u0, 0.0, lam)),
                          "KM1+KM2": lambda: out.update(km=km(u0, 0.0, lam))})
        ms = {name: statistics.mean(t) for name, t in turns.items()}
        d = [float((g - w).abs().max()) for g, w in zip(out["km"], out["k12"])]
        say("36", f"(c) KM/K1K2 at N={n_order} in turns: {ms['KM1+KM2'] / ms['K1+K2']:.3f} (KM1+KM2 "
                  f"{ms['KM1+KM2']:.3f} ms, {turns['KM1+KM2'][0]:.3f} / {turns['KM1+KM2'][1]:.3f}; "
                  f"K1+K2 {ms['K1+K2']:.3f} ms, {turns['K1+K2'][0]:.3f} / {turns['K1+K2'][1]:.3f}; "
                  f"CUDA launches KM1 {dg_mxu.km_fwd_traj.cuda_launches}, KM2 "
                  f"{dg_mxu.km_adj_est.cuda_launches}); max|KM - K1K2| u {d[0]:.3e} lam0 "
                  f"{d[1]:.3e} eta {d[2]:.3e}")
        rows[f"KM/K1K2 N={n_order}"] = ms["KM1+KM2"] / ms["K1+K2"]
        del out, km, k12
        torch.cuda.empty_cache()
    for key, ms in f3_launches(device, inp, errs).items():
        rows[f"F3 {key}"] = ms
    ode = odes.get_ode("du/dt=sin(u)")
    kw = dict(n_steps0=FD_STUDY["n_steps0"], tol=0.0, maxit=FD_STUDY["maxit"],
              dtype=torch.float32, device=device, device_loop=True, ode=ode)

    def study():
        fd_loop.run_adaptive_fd_per_member(euler_step(ode.f), study_u0s(), (0.0, FD_STUDY["t1"]),
                                           engine="cuda", **kw)

    def one_lane():
        with mock.patch.object(fe, "fd_pm_plan", lambda b, n, rf: fe.FdPmLaunch(1, 128)):
            study()

    turns = in_turns({"fd_pm_plan": study, "one lane a member": one_lane}, runs=3)
    its = FD_STUDY["maxit"] + 1
    say("36", f"(e) the FD per-member study B={FD_STUDY['b']} (device loop, {its} iterations) in "
              f"turns, median of 3 each: on fd_pm_plan's launch "
              f"{statistics.mean(turns['fd_pm_plan']):.3f} ms ({turns['fd_pm_plan'][0]:.3f} / "
              f"{turns['fd_pm_plan'][1]:.3f}), on one lane a member "
              f"{statistics.mean(turns['one lane a member']):.3f} ms "
              f"({turns['one lane a member'][0]:.3f} / {turns['one lane a member'][1]:.3f})")
    study_trace(study, "fd_estimate_per_member_kernel", phase="36")
    study_trace(one_lane, "fd_estimate_per_member_kernel", phase="36 (one lane a member)")
    return rows


# KT1's (s_f, CTA size) candidates beside the wrapper's plan (forward_plan's
# search: s_f 4-32 on 512- and 1024-thread CTAs)
KT1_STEPS = (4, 8, 16, 32)


def kt1_plans(row, device, sms):
    """KT1 (K1's fused kernel at B = 1, every step stored, from the global
    step offset) at a TILED_ROWS row on the wrapper's plan and, for each
    (s_f, CTA size) of KT1_STEPS × FUSED_THREADS, the tiling K1's cost model
    rates cheapest, timed in turns, each with its CUDA launches, the model,
    the FWD_STEP_WARP_US it implies and its share of the bound; every plan's
    trajectory and u_final, whole and one segment a call, the stored
    pipeline's K1 bits (a gate); then the tiled pipeline against the stored
    one in turns, bit-equal. Returns {key: ms}."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    k, seg, chunks, n_steps = row
    disc = startup_1d(2, 0.0, 2 * np.pi, k)
    dt = cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    tiled = dg_tiled.make_cuda_fwd_adj_estimate_tiled_grid(
        disc, A, dt, segment=seg, n_segments=n_steps // seg, chunks=chunks, device=device)
    want = dg_rhs.fwd_march(u0[:, None].contiguous(), 0.0, n_steps, ops, store_trajectory=True)
    want = (want[0][:, :, 0], want[1][:, 0])
    plans = {"wrapper's plan": dg_rhs.forward_plan(k, 1, disc.np_, n_steps, 1, sms)}
    for st in KT1_STEPS:
        for th in dg_rhs.FUSED_THREADS:
            plans[f"s_f={st} {th} threads"] = dg_rhs._cheapest(
                dg_rhs._tilings(k, 1, sms, dg_rhs.fwd_fused_plan(k, st, th)),
                lambda plan: dg_rhs._fwd_cost(k, 1, disc.np_, n_steps, 1, plan, sms))
    out, counts = {}, {}

    def on(key, plan):
        def run():
            out.pop(key, None)
            *out[key], counts[key] = dg_tiled._kt1_launch(u0, 0.0, n_steps, ops, plan)

        return run

    def wrapper():
        out.pop("wrapper", None)
        out["wrapper"] = dg_tiled.tiled_fwd_seg(u0, 0.0, n_steps // seg, tiled.plan, ops)

    turns = in_turns({"wrapper": wrapper, **{key: on(key, plan) for key, plan in plans.items()}})
    counts["wrapper"] = dg_tiled.tiled_fwd_seg.cuda_launches
    b_ms, b_by = advec_bounds(disc.np_, k, n_steps)["tiled_fwd_seg"]
    rows = {}
    for key, plan in {"wrapper": plans["wrapper's plan"], **plans}.items():
        ms = rows[key] = statistics.mean(turns[key])
        warps = max(-(-plan.n_tiles // sms) * -(-min(plan.tile + 2 * plan.ghost, k) // 32),
                    dg_rhs.MIN_WARPS)
        model = dg_rhs._fwd_cost(k, 1, disc.np_, n_steps, 1, plan, sms) / 1e3
        implied = (ms * 1e3 - counts[key] * dg_rhs.LAUNCH_US) / (n_steps * warps)
        parts, u = [], u0
        for si in range(n_steps // seg):
            traj, u, _ = dg_tiled._kt1_launch(u, 0.0, seg, ops, plan, si * seg)
            parts.append(traj)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y)) for x, y in zip(out[key], want))
        seg_same = bool(torch.equal(torch.cat(parts), want[0])) and bool(torch.equal(u, want[1]))
        del parts
        say("37", f"(b) KT1 K={k} N=2 B=1 steps={n_steps} segment={seg} {key}: s_f={plan.segment} "
                  f"W={plan.ghost} L={plan.tile} {plan.threads} threads ({plan.n_tiles} CTAs, "
                  f"{warps} warps on the busiest SM, ghost 2W/L "
                  f"{2 * plan.ghost / plan.tile:.1%}); {ms:.3f} ms (model {model:.3f}, implied "
                  f"FWD_STEP_WARP_US {implied:.4f}; in turns, median of 5 each: "
                  f"{turns[key][0]:.3f} / {turns[key][1]:.3f}), {counts[key]} CUDA launches, "
                  f"{b_ms / ms:.2%} of the {b_ms:.3f} ms bound ({b_by}); traj and u_final the "
                  f"stored pipeline's K1 bits: whole {same}, one {seg}-step segment a call "
                  f"{seg_same}")
        assert same and seg_same and counts[key] == -(-n_steps // plan.segment), key
    say("37", f"(b) KT1 K={k}: the wrapper {rows['wrapper']:.3f} ms; fastest "
              f"{min(rows, key=rows.get)} {min(rows.values()):.3f} ms")
    del out, want
    torch.cuda.empty_cache()
    stored = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, n_steps, device)
    res = {}
    turns = in_turns({"stored": lambda: res.update(s=stored(u0, 0.0, lam)),
                      "tiled": lambda: res.update(t=tiled(u0, 0.0, lam))})
    same = [bool(torch.equal(x, y)) for x, y in zip(res["s"], res["t"])]
    ms = {key: statistics.mean(t) for key, t in turns.items()}
    say("37", f"(b) K={k} tiled_grid/stored {ms['tiled'] / ms['stored']:.3f} in turns (tiled "
              f"{ms['tiled']:.3f} ms, {turns['tiled'][0]:.3f} / {turns['tiled'][1]:.3f}, "
              f"{dg_tiled.tiled_fwd_seg.cuda_launches} + {dg_tiled.tiled_rev_seg.cuda_launches} "
              f"CUDA launches; stored {ms['stored']:.3f} ms, {turns['stored'][0]:.3f} / "
              f"{turns['stored'][1]:.3f}); u_final, lam0, eta bit-equal: {same}")
    assert all(same), f"K={k}: the tiled pipeline is not the stored pipeline's bits"
    rows["tiled/stored"] = ms["tiled"] / ms["stored"]
    del res
    torch.cuda.empty_cache()
    return rows


# F1's cases: FD_ENSEMBLE's shape in both trig modes (the signal path), and
# 4,096 ICs (phase 6(c')'s count), where a group of lanes serves an IC
F1_CASES = (("libm", 102_400), ("fast", 102_400), ("libm", 4096))


def f1_launches(device, inp, errs):
    """F1 at F1_CASES on every G of PM_LANES and CTA size of PM_THREADS,
    timed in turns beside the wrapper and G = 1, each within
    fd_kernel_tolerance (some plain entry above it) and a
    repeat bit-identical (a gate), on the device alone (20 calls queued
    behind a sleep) beside the call, with its share of fd_bounds; the
    ensemble signal's argmax (the mean over ICs) the float64 plain
    version's where its top-two margin clears twice the tolerance. Returns
    {(trig, n_ics, lanes, threads): ms}."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_steps", "rf", "dt"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {}
    for trig, n in F1_CASES:
        u0 = inp["u0"][:n].contiguous()
        mine = fe.fd_ens_plan(n, s, rf, sms)
        b_ms, b_by = fd_bounds(n)["fd_ensemble"]
        run = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, trig=trig, device=device)
        stats = {}
        want = fe.fd_ensemble_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf)
        above = int((want.abs() > tol).sum())
        launches = {(g, th): fe.FdEnsLaunch(g, th) for g in fe.PM_LANES for th in fe.PM_THREADS}
        out = {}

        def on(key, launch):
            def go():
                out[key] = fe._f1_launch(u0, run.plan, launch)

            return go

        turns = in_turns({"wrapper": lambda: out.update(wrapper=run(u0)),
                          **{key: on(key, launch) for key, launch in launches.items()}})
        for key, launch in launches.items():
            ms = rows[(trig, n, *key)] = statistics.mean(turns[key])
            dev = queued_ms(on(key, launch))
            again = fe._f1_launch(u0, run.plan, launch)
            torch.cuda.synchronize()
            repeat = bool(torch.equal(out[key], again))
            e = float((out[key] - want).abs().max())
            errs["fd_ensemble"] = max(errs["fd_ensemble"], e)
            say("37", f"(c) F1 {n} ICs trig={trig} G={launch.lanes} {launch.threads} threads"
                      f"{' (the wrapper plan)' if launch == mine else ''}: "
                      f"{ms:.4f} ms a call (in turns, median of 5 each: {turns[key][0]:.4f} / "
                      f"{turns[key][1]:.4f}), {dev:.4f} ms on the device alone, {b_ms / dev:.2%} of "
                      f"the {b_ms:.5f} ms bound ({b_by}); max|err - plain| {e:.3e} (tol "
                      f"{tol:.3e}, {above} plain entries above it); a repeat bit-identical: "
                      f"{repeat}")
            assert e <= tol and above > 0 and repeat, (trig, n, key)
        same = bool(torch.equal(out["wrapper"], out[tuple(mine)]))
        dev = {"the wrapper": queued_ms(lambda: run(u0)),
               "G=1 128 threads": queued_ms(on((1, 128), launches[(1, 128)]))}
        want64 = fe.fd_ensemble_plain(u0.double(), run.plan).mean(1)
        top2 = torch.topk(want64, 2).values
        margin = float(top2[0] - top2[1])
        got_arg, want_arg = int(out["wrapper"].double().mean(1).argmax()), int(want64.argmax())
        fastest = min(launches, key=lambda x: statistics.mean(turns[x]))
        say("37", f"(c) F1 {n} ICs trig={trig}: the wrapper ({mine}) "
                  f"{statistics.mean(turns['wrapper']):.4f} ms a call, {dev['the wrapper']:.4f} on "
                  f"the device alone (G=1 128 threads {dev['G=1 128 threads']:.4f}); fastest call "
                  f"{launches[fastest]} {statistics.mean(turns[fastest]):.4f} ms; the wrapper the "
                  f"plan's launch's bits: {same}; the signal's argmax step {got_arg} against the "
                  f"float64 plain version's {want_arg} (top-two margin {margin:.3e}, 2·tol "
                  f"{2 * tol:.3e})")
        assert same, (trig, n)
        assert got_arg == want_arg or margin <= 2 * tol, (trig, n)
    return rows


def phase37(device, lib, errs, inp):
    """KT1 as a call of K1's fused march and F1 with G lanes an IC: (a) the
    registers and spills ptxas reported for fwd_fused and
    fd_ensemble_kernel (a gate: no instance spills); (b) KT1's plans at
    both TILED_ROWS in turns, bit-equal to the stored pipeline's K1 whole and
    one segment a call, and tiled/stored in turns; (c) F1 and F1-fast on
    every G and CTA size at FD_ENSEMBLE's shape, in turns."""
    import torch

    regs = kernel_registers(lib.build_log, ("fwd_fused",))
    f1, name = [], None
    for ln in lib.build_log.splitlines():
        if "Function properties for" in ln:
            name = ln.split(" for ", 1)[1].strip()
            name = name if "fd_ensemble_kernel" in name else None
            frame = ""
        elif name and "spill" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            f1.append(f"{instance_name(name)}: {ln.split('Used ', 1)[1].split(',')[0]}, {frame}")
            name = None
    say("37", f"(a) ptxas -v for fwd_fused ({len(regs)} instances): {'; '.join(regs)}")
    say("37", f"(a) ptxas -v for fd_ensemble_kernel ({len(f1)} instances): {'; '.join(sorted(f1))}")
    clean = "0 bytes spill stores, 0 bytes spill loads"
    assert regs and all(clean in r for r in regs), "a fwd_fused instance spills"
    assert f1 and all(clean in r for r in f1), "an fd_ensemble_kernel instance spills"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {}
    for row in TILED_ROWS:
        for key, ms in kt1_plans(row, device, sms).items():
            rows[f"KT1 K={row[0]} {key}"] = ms
    for key, ms in f1_launches(device, inp, errs).items():
        rows[f"F1 {key}"] = ms
    return rows


# ------------------------------------------------- the goal and bf16 modes

# D1 with a goal at the per-member study's shape and bench.py's (label, B, K,
# Newton steps, per-member partitions, seed); H1's at HP_STUDY's and HP_BIG's
D1_GOAL_CASES = (("the per-member study's shape", 1024, 15, 8, True, 2),
                 ("bench.py's shape", 16_384, 16, 5, False, 1))
T2_BF16_ROWS = ((8192, 10), (8192, 100), (512, 2))  # bench.py's rows; the recurrent path's
# sha256 (16 hex digits) of the parent 81c75ac kernels' outputs (J = ∫u; T2
# in float32) on these inputs, printed by tools/torch_goal_bf16_against_parent.py
# on an NVIDIA H100 80GB HBM3 at 700 W: D1 and H1 at their wrapper's launch,
# T2 over every (BM, C) plan in _feasible's order. The goal and bf16 modes
# must leave these bits alone. F1, F2 and F3 (sin u, the harmonic oscillator,
# sin u strided) at fd_inputs' phase-6 inputs: the parent ef762ac's, printed
# by tools/torch_fd_digests.py on the same card; the traced functors (phase
# 42) must leave the registry modes' bits alone.
PARENT_DIGESTS = {"D1 1024": "9c17a77a54f01917", "D1 16384": "35680304e7695012",
                  "H1 512 solve": "7be8588c848bcbd8", "H1 512 reconstruct": "3cf395845c3eb3a9",
                  "H1 4096 solve": "a4163c588a154456", "T2 8192 10": "e587078b00801107",
                  "T2 512 2": "c1952e2d913c163e", "F1 102400": "0a1187cfdd680f43",
                  "F2 102400": "891f5a68da654eaa", "F3 1024": "a795d3ab8a92e180",
                  # F2 on phase 42's traced callables at d = 2-4 (tools/torch_fd_digests.py
                  # on the parent 14fbbe5)
                  "F2 traced d=2 102400": "6d66aa475b7a4023",
                  "F2 traced d=3 102400": "08aa1bf8783ed289",
                  "F2 traced d=4 102400": "d969f099e31c2beb",
                  # the register advection and Burgers kernels at N = 1-7 (Np 2-8),
                  # tools/torch_dg_digests.py on the parent a5c8d6d
                  "K1 N=1": "105cf4d25e582f65", "K2 N=1": "56710e3c0902635c",
                  "K2r N=1": "3de4c9a434ad1765", "KA N=1": "8fbd4b304244f510",
                  "B1 N=1 f32": "c793da331f5d7337", "B1 N=1 f64": "ea65d90c9316f0dc",
                  "K1 N=2": "b6a96f51be0019d9", "K2 N=2": "ca4ff416ed962035",
                  "K2r N=2": "6155e96690f1d13c", "KA N=2": "3561c26ffa0a9b0e",
                  "B1 N=2 f32": "d12933c2af62127c", "B1 N=2 f64": "121590ca93f2509f",
                  "K1 N=3": "26585d0b0db41c74", "K2 N=3": "e5abb4f9f8f85f3f",
                  "K2r N=3": "cfbad8d2299d1ca7", "KA N=3": "fd9a2e3ecd5b5392",
                  "B1 N=3 f32": "71449ce405635ba4", "B1 N=3 f64": "c1da4741f75b0670",
                  "K1 N=4": "6761d42f3bbe39f2", "K2 N=4": "44ede74036e24ee3",
                  "K2r N=4": "4138b1cecbec5ed1", "KA N=4": "ba260d2e20437022",
                  "B1 N=4 f32": "eb0fefaacdc7398b", "B1 N=4 f64": "393de5950454f3b3",
                  "K1 N=5": "1253246026729520", "K2 N=5": "e50bd56bca6a4288",
                  "K2r N=5": "0d52d4ca4872491d", "KA N=5": "faa86b294be19b8b",
                  "B1 N=5 f32": "0a2de6b407dadc32", "B1 N=5 f64": "3a014a9c7564a2f3",
                  "K1 N=6": "23ba46af2df7e1e7", "K2 N=6": "b99fcf7aab0fe6bb",
                  "K2r N=6": "72c6706dc6dc131d", "KA N=6": "053c1ccbdf3cb4a2",
                  "B1 N=6 f32": "a4d015bfc1064461", "B1 N=6 f64": "a3d287b0531ae174",
                  "K1 N=7": "047c9ab15bebba60", "K2 N=7": "04b03bf7a38f8ada",
                  "K2r N=7": "6e018897ab8daed0", "KA N=7": "5c88ab1a043137ff",
                  "B1 N=7 f32": "9dd059cdf5eaba84", "B1 N=7 f64": "e73bec7dccd422e3"}
BF16_TFLOPS = 989e12  # dense bf16 on the tensor cores (NVIDIA data sheet, H100 SXM)


def digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def goal_d1_inputs(device, b, k, per_member, seed):
    """y0 ~ U(0.5, 2) from ``default_rng(seed)``, and per-member partitions
    of [0, 2] with zero-width tails (dg_case's draw) or the uniform one."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y0 = torch.tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32, device=device)
    if per_member:
        t = np.full((b, k + 1), DG_SLAB["t1"])
        for m, n_act in enumerate(rng.integers(2, k - 3, b)):
            t[m, : n_act + 1] = np.concatenate(
                [[0.0], np.sort(rng.uniform(0.0, DG_SLAB["t1"], n_act - 1)), [DG_SLAB["t1"]]])
    else:
        t = np.linspace(0.0, DG_SLAB["t1"], k + 1)
    return torch.tensor(t, dtype=torch.float32, device=device), y0


def t2_bf16_bound(s_steps, sizes, b):
    """Least time for one T2 call in the bf16 mode: its inputs and
    gradients once over 3.35 TB/s, against the hidden products'
    8·B·S·Σ H_{l−1}H_l bf16 tensor operations over 989 TFLOP/s plus the
    f32 elementwise work (t2_bound's B·S·(12·H_1 + 14·H_L)) over 67
    TFLOP/s. Returns (ms, by, bf16 operations)."""
    hh = sum(a * c for a, c in zip(sizes[:-1], sizes[1:]))
    n_params = 2 * sizes[0] + hh + sum(sizes[1:]) + sizes[-1] + 1
    n_bytes = 4 * (2 * n_params + hh + s_steps + 2 * b + 1)
    tc_ops = 8 * b * s_steps * hh
    t_ops = tc_ops / BF16_TFLOPS + b * s_steps * (12 * sizes[0] + 14 * sizes[-1]) / FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", tc_ops


def d1_goal_case(label, b, k, newton, per_member, seed, device, errs):
    """Phase 38(a): D1 with J = ∫u² on every (G, CTA size) against its
    plain version within the extended bounds (a gate), some plain |err|
    above its bound, the J = ∫u kernel outside the v bound; the J = ∫u
    wrapper's bits against the parent's digest; the two goals in turns.
    Returns (goal ms, J = ∫u ms, plain ms, bound)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import functionals
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    times, y0 = goal_d1_inputs(device, b, k, per_member, seed)
    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    u2 = functionals.get_functional("J=int(u^2)")
    run = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, newton,
                                            g_u=u2.g_u, device=device)
    unit = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, newton,
                                             device=device)
    want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
    tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
    worst = {x: 0.0 for x in ("u", "v", "err")}
    launches = [ds.D1Launch(g, th) for g in (*ds.LANES, 32) for th in ds.CTA_THREADS]
    for launch in launches:
        e, share = d1_shares(ds._d1_launch(times, y0, run.plan, launch), want, tol)
        errs["dg_estimate_ensemble[J=int(u^2)]"] = max(errs["dg_estimate_ensemble[J=int(u^2)]"],
                                                       *e.values())
        worst = {x: max(worst[x], share[x]) for x in worst}
    unit_out = unit(times, y0)
    torch.cuda.synchronize()
    teeth = int((want[2].abs() > tol["err"]).sum())
    bites = int(((unit_out[1] - want[1]).abs().double() > tol["v"]).any(dim=-1).sum())
    bits = digest(unit_out)
    key = f"D1 {b}"
    nqp, nqa = ops_p.phi.shape[0], ops_a.phi.shape[0]
    mine = ds.d1_plan(b, 2, max(nqp, nqa))
    turns = in_turns({"J=int(u^2)": lambda: run(times, y0), "J=int(u)": lambda: unit(times, y0)},
                     runs=3)
    ms, ms0 = (statistics.mean(turns[x]) for x in ("J=int(u^2)", "J=int(u)"))
    plain_ms = cuda_ms(lambda: ds.dg_estimate_ensemble_plain(times, y0, run.plan), runs=1)
    b_ms, b_by = dg_slab_bound(1, k, b, newton, nqp, nqa, per_member, goal=True)
    say("38", f"(a) D1 J=int(u^2) {label} B={b} K={k}: {len(launches)} (G, CTA) launches and the "
              f"wrapper ({mine}) within the extended per-element bounds, worst share "
              + " ".join(f"{x} {worst[x]:.2%}" for x in worst)
              + f"; {teeth} plain |err| above their bound; the J=int(u) kernel's v outside it on "
                f"{bites} member-elements; J=int(u) bits {bits} (the parent's "
                f"{PARENT_DIGESTS.get(key, 'not recorded')}); in turns J=int(u^2) {ms:.4f} ms "
                f"({turns['J=int(u^2)'][0]:.4f} / {turns['J=int(u^2)'][1]:.4f}) against J=int(u) "
                f"{ms0:.4f} ms ({turns['J=int(u)'][0]:.4f} / {turns['J=int(u)'][1]:.4f}), "
                f"{ms / ms0:.3f}x; plain {plain_ms:.3f} ms; bound {b_ms:.6f} ms ({b_by}), "
                f"{b_ms / ms:.3%} of it")
    assert max(worst.values()) <= 1.0, f"{label}: D1 with the goal disagrees"
    assert teeth > 0 and bites > 0, f"{label}: the extended D1 bounds have no teeth"
    assert key not in PARENT_DIGESTS or PARENT_DIGESTS[key] == bits, f"{label}: J=int(u) bits moved"
    return ms, ms0, plain_ms, (b_ms, b_by)


def h1_goal_case(b, seed, mode, device, errs):
    """Phase 38(b): H1 with J = ∫u² at HP_STUDY's orders on every (G, CTA
    size), as d1_goal_case. Returns (goal ms, J = ∫u ms, plain ms, bound)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import functionals
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    inputs = hp_inputs(device, b, HP_K, HP_STUDY["n_max"], seed)
    u2 = functionals.get_functional("J=int(u^2)")
    run = hp_kernel("du/dt=sin(u)", HP_STUDY["n_max"], HP_STUDY["fo"], HP_K, mode, device,
                    u2.g_u)
    unit = hp_kernel("du/dt=sin(u)", HP_STUDY["n_max"], HP_STUDY["fo"], HP_K, mode, device)
    names = ("u_c", "u_f", "v", "err")
    want = hm.dg_estimate_hp_per_member_plain(*inputs, run.plan)
    tol = hm.hp_kernel_tolerance(*inputs, want, run.plan)
    worst = {x: 0.0 for x in names}
    launches = [hm.HpLaunch(g, th) for g in HP_LANES for th in hm.CTA_THREADS]
    for launch in launches:
        e, share = hp_shares(hm._h1_launch(*inputs, run.plan, launch), want, tol)
        key = "dg_estimate_hp_per_member[J=int(u^2)]"
        errs[key] = max(errs[key], *e.values())
        worst = {x: max(worst[x], share[x]) for x in worst}
    unit_out = unit(*inputs)
    torch.cuda.synchronize()
    teeth = int((want[3].abs() > tol["err"]).sum())
    bites = int(((unit_out[2] - want[2]).abs().double() > tol["v"]).any(dim=-1).sum())
    bits = digest(unit_out)
    key = f"H1 {b} {mode}"
    turns = in_turns({"J=int(u^2)": lambda: run(*inputs), "J=int(u)": lambda: unit(*inputs)},
                     runs=3)
    ms, ms0 = (statistics.mean(turns[x]) for x in ("J=int(u^2)", "J=int(u)"))
    plain_ms = cuda_ms(lambda: hm.dg_estimate_hp_per_member_plain(*inputs, run.plan), runs=1)
    plan = run.plan
    b_ms, b_by = dg_hp_bound(inputs[0], inputs[1], plan.newton_iters, plan.fine_offset,
                             plan.mops.rq.shape[0], plan.mops.np_max, mode, goal=True)
    mine = hm.hp_plan(b, plan.mops.np_max, plan.mops.rq.shape[0])
    say("38", f"(b) H1 J=int(u^2) B={b} K={HP_K} {mode}: {len(launches)} (G, CTA) launches and the "
              f"wrapper ({mine}) within the extended per-element bounds, worst share "
              + " ".join(f"{x} {worst[x]:.2%}" for x in worst)
              + f"; {teeth} plain |err| above their bound; the J=int(u) kernel's v outside it on "
                f"{bites} member-elements; J=int(u) bits {bits} (the parent's "
                f"{PARENT_DIGESTS.get(key, 'not recorded')}); in turns J=int(u^2) {ms:.4f} ms "
                f"({turns['J=int(u^2)'][0]:.4f} / {turns['J=int(u^2)'][1]:.4f}) against J=int(u) "
                f"{ms0:.4f} ms ({turns['J=int(u)'][0]:.4f} / {turns['J=int(u)'][1]:.4f}), "
                f"{ms / ms0:.3f}x; plain {plain_ms:.3f} ms; bound {b_ms:.6f} ms ({b_by}), "
                f"{b_ms / ms:.3%} of it")
    assert max(worst.values()) <= 1.0, f"B={b} {mode}: H1 with the goal disagrees"
    assert teeth > 0 and bites > 0, f"B={b} {mode}: the extended H1 bounds have no teeth"
    assert key not in PARENT_DIGESTS or PARENT_DIGESTS[key] == bits, f"B={b} {mode}: bits moved"
    return ms, ms0, plain_ms, (b_ms, b_by)


def goal_studies(device, errs):
    """Phase 38(c): the per-member DG study of phase 10 (B = 1024) and the
    hp study of phase 13 (B = 512, solve) through their loops with the goal
    J = ∫u² on the kernels, launches counted, every iteration replayed as
    phases 10 and 13 replay theirs. Returns the launches of each kernel."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import functionals, odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, hp_loop
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    sin = odes.get_ode("du/dt=sin(u)")
    u2 = functionals.get_functional("J=int(u^2)")
    goal = dict(g=lambda u, t: u * u, g_u=u2.g_u, f_u=sin.f_u, engine="cuda", ode=sin,
                device_loop=True, dtype=torch.float32, device=device)
    y0s = np.random.default_rng(0).uniform(0.5, 2.0, 1024).astype(np.float32)
    ds.reset_launch_counts()
    t0 = time.perf_counter()
    hist = dg_loop.run_adaptive_dg_per_member(sin.f, y0s, (0.0, DG_SLAB["t1"]), n_order=1, k0=2,
                                              tol=1e-5, maxit=30, newton_iters=8, **goal)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_d1 = ds.dg_estimate_ensemble.launches
    assert n_d1 > 0 and all(np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j)) for r in hist)
    rep = dg_replay(hist, device, errs, u2.g_u, "dg_estimate_ensemble[J=int(u^2)]")
    last = hist[-1]
    say("38", f"(c) run_adaptive_dg_per_member B=1024 J=int(u^2) (g_u on the card, device loop, "
              f"phase 10's study): {len(hist)} iterations, K [{last.n_active.min()}.."
              f"{last.n_active.max()}], {last.n_refining} refining, mean |Adj-W Res| "
              f"{np.abs(hist[0].est_total).mean():.3e} -> {np.abs(last.est_total).mean():.3e}, "
              f"wall {wall:.3f} s, D1 launches {n_d1}; replay: max|d err| {rep['err']:.3e} "
              f"(worst {rep['share']:.2%} of its bound), decisions clear of 4x the bound "
              f"{rep['decided']}, kernel and plain agree on {rep['agree']}; float64 torch engine "
              f"{rep['decided64']} / {rep['agree64']}")
    y_hp = np.random.default_rng(HP_STUDY["seed"]).uniform(0.5, 2.0, HP_STUDY["b"]).astype(
        np.float32)
    hm.reset_launch_counts()
    t0 = time.perf_counter()
    hist = hp_loop.run_adaptive_dg_hp_per_member(
        sin.f, y_hp, (0.0, HP_STUDY["t1"]), k0=HP_STUDY["k0"], n0=1, n_max=HP_STUDY["n_max"],
        mode="hp", tol=0.0, maxit=HP_STUDY["maxit"], newton_iters=HP_STUDY["newton_iters"],
        **goal)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_h1 = hm.dg_estimate_hp_per_member.launches
    assert n_h1 == len(hist) == HP_STUDY["maxit"] + 1, (n_h1, len(hist))
    assert all(np.all(np.isfinite(r.err)) and np.all(np.isfinite(r.j_coarse)) for r in hist)
    rep = hp_replay(hist, "solve", device, errs, u2.g_u, "dg_estimate_hp_per_member[J=int(u^2)]")
    last = hist[-1]
    say("38", f"(c) run_adaptive_dg_hp_per_member B={HP_STUDY['b']} J=int(u^2) (phase 13's study, "
              f"solve): {len(hist)} iterations, K [{last.n_active.min()}..{last.n_active.max()}], "
              f"max order {last.ns.max()}, mean |est| {np.abs(hist[0].est_total).mean():.3e} -> "
              f"{np.abs(last.est_total).mean():.3e}, wall {wall:.3f} s, H1 launches {n_h1}; "
              f"replay: max|d err| {rep['err']:.3e} (worst {rep['share']:.2%} of its bound), "
              f"decisions clear of 4x the bound {rep['decided']}, kernel and plain agree on "
              f"{rep['agree']}; float64 torch engine {rep['decided64']} / {rep['agree64']}")
    return {"dg_estimate_ensemble[J=int(u^2)]": n_d1,
            "dg_estimate_hp_per_member[J=int(u^2)]": n_h1}


def t2_bf16_row(b, s_steps, device, errs, hold_every, time_every):
    """Phase 38(d): T2's bf16 mode at one row against its float64 plain
    version within the bf16 bound (a gate; on every (BM, C) with
    ``hold_every``, else the wrapper's), the float32 mode outside it
    somewhere; with ``time_every`` the float32 mode's bits over every plan
    against the parent's digest, and every bf16 plan timed in turns beside
    the bf16 and float32 wrappers and torch.matmul's bf16 GEMMs. Returns
    (bf16 ms, f32 ms, GEMMs ms, plain ms, bound)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td

    bf = torch.bfloat16
    sizes = NN_T2["sizes"]
    params, dt, u0, tr = nn_t2_inputs(device, s_steps)
    u0, tr = u0[:b].contiguous(), tr[:b].contiguous()
    theta, theta16 = td.pack_dense(params, sizes, device), td.pack_dense(params, sizes, device, bf)
    sms = td._sm_count(device)
    mine = td.dense_plan(sizes, b, sms, bf)
    plans = {(bm, c): td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c, bf), True)
             for bm, c in td._feasible(sizes, bf)}
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    a64 = (dt.double(), u0.double(), tr.double())
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, *a64, mxu_dtype=bf)
    _, f64 = td.dense_epoch_grad_plain(p64, sizes, *a64)
    worst, outside = 0.0, 0
    for key, plan in (plans.items() if hold_every else [((mine.block_members, mine.cluster), mine)]):
        loss, flat = td._t2_launch(theta16, sizes, dt, u0, tr, plan)
        loss2, flat2 = td._t2_launch(theta16, sizes, dt, u0, tr, plan)
        torch.cuda.synchronize()
        assert torch.equal(flat, flat2) and torch.equal(loss, loss2), (b, s_steps, key)
        got = td.unpack_dense(flat, sizes, bf)
        tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, *key, bf)
        assert abs(float(loss) - float(l64)) <= tol["loss"], (b, s_steps, key, "loss")
        for k in g64:
            for q in g64[k]:
                bnd = tol["grads"][k][q]
                d = (got[k][q].double() - g64[k][q]).abs()
                assert bool((d <= bnd).all()), f"T2 bf16 B={b} S={s_steps} {key} {k}/{q}"
                worst = max(worst, float((d / bnd.clamp_min(1e-300)).max()))
                errs["dense_epoch_grad[bf16]"] = max(errs["dense_epoch_grad[bf16]"],
                                                     float(d.max()))
                if key == (mine.block_members, mine.cluster):
                    outside += int(((f64[k][q] - g64[k][q]).abs() > bnd).sum())
    assert outside > 0, f"T2 bf16 B={b} S={s_steps}: the bf16 bound cannot tell the f32 mode"
    f32_bits = ""
    if time_every:  # the float32 mode's bits on every plan
        outs = []
        for bm, c in td._feasible(sizes):
            outs += td._t2_launch(theta, sizes, dt, u0, tr,
                                  td.DensePlan(bm, c, -(-b // bm), td.dense_smem_bytes(sizes, bm, c)))
        f32_bits = digest(outs)
        key = f"T2 {b} {s_steps}"
        assert key not in PARENT_DIGESTS or PARENT_DIGESTS[key] == f32_bits, f"{key}: f32 bits moved"
        f32_bits = f"; float32 bits over every plan {f32_bits} (the parent's " \
                   f"{PARENT_DIGESTS.get(key, 'not recorded')})"
    a, w = (torch.rand(x, device=device, dtype=bf) for x in ((b, sizes[0]), sizes))
    dz = torch.rand((b, sizes[1]), device=device, dtype=bf)

    def gemms():
        for _ in range(s_steps):
            a @ w, a @ w, a.T @ dz, dz @ w.T  # forward, recompute, ∂W, ∂a

    runs = {"bf16 wrapper": lambda: td.dense_epoch_grad(theta16, sizes, dt, u0, tr, bf),
            "f32 wrapper": lambda: td.dense_epoch_grad(theta, sizes, dt, u0, tr),
            "torch.matmul bf16 GEMMs": gemms}
    if time_every:
        runs.update({f"bf16 {key}": (lambda p: lambda: td._t2_launch(theta16, sizes, dt, u0, tr, p))(
            plan) for key, plan in plans.items()})
    turns = in_turns(runs)
    ms, ms32, gms = (statistics.mean(turns[x]) for x in ("bf16 wrapper", "f32 wrapper",
                                                          "torch.matmul bf16 GEMMs"))
    plain_ms = cuda_ms(lambda: td.dense_epoch_grad_plain(params, sizes, dt, u0, tr, bf), runs=1)
    b_ms, b_by, tc_ops = t2_bf16_bound(s_steps, sizes, b)
    say("38", f"(d) T2 bf16 {sizes} B={b} S={s_steps}: {len(plans) if hold_every else 1} plan(s) "
              f"within the bf16 bound of the float64 bf16 plain version (worst {worst:.2%}), the "
              f"float32 mode outside it at {outside} entries{f32_bits}; the wrapper "
              f"({mine.block_members}, {mine.cluster}) {ms:.4f} ms "
              f"({tc_ops / (ms / 1e3) / 1e12:.2f} TFLOP/s of its bf16 products; {b_ms / ms:.2%} "
              f"of the {b_ms:.5f} ms bound, {b_by}), the float32 wrapper {ms32:.4f} ms "
              f"({ms32 / ms:.2f}x), torch.matmul's bf16 GEMMs {gms:.4f} ms (the kernel at "
              f"{ms / gms:.3f}x of them); plain {plain_ms:.3f} ms; in turns: "
              + "; ".join(f"{x} {statistics.mean(t):.4f} ({t[0]:.4f} / {t[1]:.4f})"
                          for x, t in turns.items()))
    return ms, ms32, gms, plain_ms, (b_ms, b_by)


def bf16_train_steps(device):
    """Phase 38(e): five steps of make_shared_train_step_fused(...,
    mxu_dtype=bfloat16) at (100, 500), S = 10, B = 8192: the loss falls and
    stays finite. Returns T2's launches."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
    from adjoint_ode_adaptivity_tpu_torch.train import loop

    params, dt, u0, tr = nn_t2_inputs(device, 10)
    tx = loop.Adam(1e-3)
    step = loop.make_shared_train_step_fused(tx, dt, NN_T2["sizes"], device=device,
                                             mxu_dtype=torch.bfloat16)
    state = loop.create_train_state(params, tx)
    td.reset_launch_counts()
    losses = []
    for _ in range(5):
        state, loss = step(state, u0, tr)
        losses.append(float(loss))
    n = td.dense_epoch_grad.launches
    say("38", f"(e) make_shared_train_step_fused(..., mxu_dtype=torch.bfloat16) {NN_T2['sizes']} "
              f"S=10 B={u0.shape[0]}: losses {', '.join(f'{x:.6e}' for x in losses)}; T2 "
              f"launches {n}")
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0] and n == 5, losses
    return n


def phase38(device, lib, errs):
    """The goal J = ∫u² on D1 and H1, and T2's bf16 mode: (a) D1 at
    D1_GOAL_CASES, (b) H1 at B = 512 (both modes) and 4096, (c) the DG and
    hp per-member studies with the goal, (d) T2 bf16 at T2_BF16_ROWS, (e)
    five bf16 train steps. Returns (launches, times, bounds) for the
    kernels line's three mode rows."""
    import re

    sass = subprocess.run([os.environ.get("CUOBJDUMP", "cuobjdump"), "-sass", str(lib.path)],
                          capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        if "dense_cluster_kernel" in name:
            mode = "bf16" if "ILb1E" in name else "float32"
            say("38", f"SASS of dense_cluster_kernel<{mode}>: {fn.count('HMMA')} HMMA, "
                      f"{fn.count('FFMA')} FFMA instructions")
            assert (fn.count("HMMA") > 0) == (mode == "bf16"), f"{mode}: tensor-core use"
    say("38", "ptxas -v: " + "; ".join(kernel_registers(
        lib.build_log, ("dense_cluster_kernel",))))
    d1 = [d1_goal_case(*case, device, errs) for case in D1_GOAL_CASES]
    h1 = [h1_goal_case(HP_STUDY["b"], HP_STUDY["seed"], "solve", device, errs),
          h1_goal_case(HP_STUDY["b"], HP_STUDY["seed"], "reconstruct", device, errs),
          h1_goal_case(HP_BIG["b"], HP_BIG["seed"], "solve", device, errs)]
    launches = goal_studies(device, errs)
    t2 = [t2_bf16_row(b, s, device, errs, hold_every=b < 8192, time_every=s < 100)
          for b, s in T2_BF16_ROWS]
    launches["dense_epoch_grad[bf16]"] = bf16_train_steps(device)
    times = {"dg_estimate_ensemble[J=int(u^2)]": (d1[1][0], d1[1][2]),
             "dg_estimate_hp_per_member[J=int(u^2)]": (h1[0][0], h1[0][2]),
             "dense_epoch_grad[bf16]": (t2[0][0], t2[0][3])}
    bounds = {"dg_estimate_ensemble[J=int(u^2)]": d1[1][3],
              "dg_estimate_hp_per_member[J=int(u^2)]": h1[0][3],
              "dense_epoch_grad[bf16]": t2[0][4]}
    return launches, times, bounds


# ------------------------------------ F2 with G lanes; the member-sharded studies

F2_CASES = (102_400, 4096)  # FD_ENSEMBLE's IC count and phase 37's small one


def f2_launches(device, inp, errs):
    """F2 at F2_CASES on every G of PM_LANES and CTA size of PM_THREADS,
    timed in turns beside the wrapper, each within fd_kernel_tolerance(…,
    d=2) (some plain entry above it) and a repeat bit-identical (a gate), on
    the device alone (20 calls queued behind a sleep) beside the call, with
    its share of fd_bounds."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_steps", "rf", "dt"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n in F2_CASES:
        u0 = inp["u0_vec"][:n].contiguous()
        mine = fe.fd_ens_plan(n, s, rf, sms, 2)
        b_ms, b_by = fd_bounds(n)["fd_ensemble_vec"]
        run = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf, d=2)
        above = int((want.abs() > tol).sum())
        launches = {(g, th): fe.FdEnsLaunch(g, th) for g in fe.PM_LANES for th in fe.PM_THREADS}
        out = {}

        def on(key, launch):
            def go():
                out[key] = fe._f2_launch(u0, run.plan, launch)

            return go

        before = fe.fd_ensemble_vec.launches
        turns = in_turns({"wrapper": lambda: out.update(wrapper=run(u0)),
                          **{key: on(key, launch) for key, launch in launches.items()}})
        counted = fe.fd_ensemble_vec.launches - before
        for key, launch in launches.items():
            ms = statistics.mean(turns[key])
            dev = queued_ms(on(key, launch))
            again = fe._f2_launch(u0, run.plan, launch)
            torch.cuda.synchronize()
            repeat = bool(torch.equal(out[key], again))
            e = float((out[key] - want).abs().max())
            errs["fd_ensemble_vec"] = max(errs["fd_ensemble_vec"], e)
            say("39", f"(b) F2 {n} ICs G={launch.lanes} {launch.threads} threads"
                      f"{' (the wrapper plan)' if launch == mine else ''}: "
                      f"{ms:.4f} ms a call (in turns, median of 5 each: {turns[key][0]:.4f} / "
                      f"{turns[key][1]:.4f}), {dev:.4f} ms on the device alone, {b_ms / dev:.2%} of "
                      f"the {b_ms:.5f} ms bound ({b_by}); max|err - plain| {e:.3e} (tol "
                      f"{tol:.3e}, {above} plain entries above it); a repeat bit-identical: "
                      f"{repeat}")
            assert e <= tol and above > 0 and repeat, (n, key)
        same = bool(torch.equal(out["wrapper"], out[tuple(mine)]))
        dev = {"the wrapper": queued_ms(lambda: run(u0)),
               "G=1 128 threads": queued_ms(on((1, 128), launches[(1, 128)]))}
        fastest = min(launches, key=lambda x: statistics.mean(turns[x]))
        say("39", f"(b) F2 {n} ICs: the wrapper ({mine}) {statistics.mean(turns['wrapper']):.4f} "
                  f"ms a call, {dev['the wrapper']:.4f} on the device alone ({b_ms / dev['the wrapper']:.2%} "
                  f"of the bound; G=1 128 threads {dev['G=1 128 threads']:.4f}); fastest call "
                  f"{launches[fastest]} {statistics.mean(turns[fastest]):.4f} ms; the wrapper the "
                  f"plan's launch's bits: {same}; wrapper launches counted {counted} for "
                  f"{2 * 6} calls (one a call)")
        assert same and counted == 12, (n, same, counted)


ENSEMBLE_STUDIES = ("dg_ensemble", "dg_per_member", "fd_per_member")
DG_DRIVER = dict(k0=2, tol=1e-5, maxit=30)  # dg_adaptive's defaults


def ensemble_study(name, device, grid):
    """One of the three studies at the drivers' shapes on the cuda engine
    (phases 7 and 10: ``dg_adaptive --ensemble 1024`` shared, ``--per-member
    --device-loop``, ``fd_adaptive --ensemble 1024 --engine cuda --device-loop
    --tol 0 --maxit 40``), members sharded over ``grid`` (None: unsharded)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step

    sin = odes.get_ode("du/dt=sin(u)")
    common = dict(engine="cuda", ode=sin, dtype=torch.float32, device=device, mesh=grid)
    if name == "fd_per_member":
        return fd_loop.run_adaptive_fd_per_member(
            euler_step(sin.f), study_u0s(), (0.0, FD_STUDY["t1"]), n_steps0=FD_STUDY["n_steps0"],
            ref_factor=FD_STUDY["rf"], tol=0.0, maxit=FD_STUDY["maxit"], device_loop=True, **common)
    # the driver's draw: U(0.5, 2) from default_rng(0), float32
    y0s = np.random.default_rng(0).uniform(0.5, 2.0, 1024).astype(np.float32)
    run = dg_loop.run_adaptive_dg_ensemble if name == "dg_ensemble" else \
        dg_loop.run_adaptive_dg_per_member
    return run(sin.f, y0s, (0.0, DG_SLAB["t1"]), f_u=sin.f_u, n_order=1, newton_iters=8,
               device_loop=name == "dg_per_member", **DG_DRIVER, **common)


def timed_studies(device, grid, sync):
    """Each study once to warm up, then once on the host clock after
    ``sync()`` (every rank starts together): name -> (history, wall s)."""
    import torch

    out = {}
    for name in ENSEMBLE_STUDIES:
        ensemble_study(name, device, grid)
        sync()
        t0 = time.perf_counter()
        hist = ensemble_study(name, device, grid)
        torch.cuda.synchronize()
        out[name] = (hist, time.perf_counter() - t0)
    return out


def ensemble_rank(rank, world, store, out_dir):
    """One rank of phase 39(c) (torch.multiprocessing.spawn): gloo over a
    FileStore, every rank on cuda:0; the global histories and the walls go
    to out_dir/rank{r}.pkl."""
    sys.path.insert(0, str(ROOT))
    import pickle

    import torch
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        grid = make_rank_grid({"data": world})
        out = timed_studies(torch.device("cuda", 0), grid, dist.barrier)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def history_digest(hist) -> str:
    """:func:`digest` of every field of every iteration of a loop's history."""
    import numpy as np
    import torch

    return digest(torch.from_numpy(np.asarray(v, dtype=np.float64)) for r in hist for v in r)


def ensemble_replay(hist, device, errs):
    """Every iteration's shared partition of the B = 1024 ensemble DG study
    through D1's plain version (float32, same card): the history's err_mean
    within the mean of the per-element bounds plus the float32 sum's
    B·ε·mean|err|, and the bisection where the plain mean's top-two margin
    clears 4x that bound the same (a gate)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    sin = odes.get_ode("du/dt=sin(u)")
    b = 1024
    y32 = torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, b).astype(np.float32),
                       device=device)
    k = DG_DRIVER["k0"] + DG_DRIVER["maxit"] + 1  # the loop's padded element count
    plan = ds.make_cuda_dg_estimate_ensemble(sin, dg_time_operators(1), dg_time_operators(2),
                                             k, 8, device=device).plan
    out = dict(decided=0, agree=0, err=0.0, share=0.0)
    for r in hist:
        t = np.concatenate([r.times, np.full(k + 1 - len(r.times), r.times[-1])])
        times = torch.tensor(t, dtype=torch.float32, device=device)[None].expand(b, -1).contiguous()
        plain = ds.dg_estimate_ensemble_plain(times, y32, plan)
        tol = ds.dg_kernel_tolerance(times, y32, plain, plan)["err"]
        na = len(r.times) - 1
        mean_p = plain[2].abs().double().mean(0)[:na]
        bound = tol.mean(0)[:na] + b * EPS32 * mean_p
        d = (torch.tensor(r.err_mean, device=device, dtype=torch.float64) - mean_p).abs()
        assert bool((d <= bound).all()), (float(d.max()), float(bound.max()))
        out["err"] = max(out["err"], float(d.max()))
        out["share"] = max(out["share"], float((d / bound).max()))
        top2 = torch.topk(mean_p, 2)
        if float(top2.values[0] - top2.values[1]) > 4 * float(bound.max()):
            out["decided"] += 1
            out["agree"] += int(int(np.argmax(r.err_mean)) == int(top2.indices[0]))
    errs["dg_estimate_ensemble"] = max(errs["dg_estimate_ensemble"], out["err"])
    assert out["decided"] > 0 and out["agree"] == out["decided"], out
    return out


def agreement(name, h1, h2):
    """Refinement decisions of two histories of one study taken on the same
    partitions: (agreeing, compared). Per member and iteration where both
    partitions are equal (per-member studies), or per iteration while the
    shared partitions are equal."""
    import numpy as np

    agree = total = 0
    for a, b in zip(h1, h2):
        if name == "dg_ensemble":
            if not np.array_equal(a.times, b.times):
                break
            total += 1
            agree += int(np.argmax(a.err_mean) == np.argmax(b.err_mean))
            continue
        err = "err_steps" if name == "fd_per_member" else "err"
        same = np.all(a.times == b.times, axis=1)
        picks = [np.argmax(np.abs(getattr(x, err)), axis=1) for x in (a, b)]
        total += int(same.sum())
        agree += int((same & (picks[0] == picks[1])).sum())
    return agree, total


def phase39(device, lib, errs, inp):
    """F2 with G lanes an IC and the member-sharded studies: (a) the
    registers and spills ptxas reported for fd_ensemble_vec_kernel (a gate:
    no instance spills); (b) F2 on every G and CTA size at 102,400 and 4,096
    ICs, in turns; (c) the DG ensemble and per-member studies and the FD
    per-member study (B = 1024, cuda engine) through parallel/ensemble.py's
    mesh=: world 1 in this process (the unsharded loop's bits), world 2 as
    two gloo ranks on the card, every decision clear of the kernels' bounds
    replayed through the plain versions."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    f2 = kernel_registers(lib.build_log, ("fd_ensemble_vec_kernel",))
    say("39", f"(a) ptxas -v for fd_ensemble_vec_kernel ({len(f2)} instances): {'; '.join(f2)}")
    clean = "0 bytes spill stores, 0 bytes spill loads"
    assert f2 and all(clean in r for r in f2), "an fd_ensemble_vec_kernel instance spills"
    f2_launches(device, inp, errs)

    # (c) world 1: the loops with mesh= a one-rank grid against mesh=None
    one = timed_studies(device, make_rank_grid({"data": 1}), lambda: None)
    ref = {name: ensemble_study(name, device, None) for name in ENSEMBLE_STUDIES}
    for name in ENSEMBLE_STUDIES:
        hist, wall = one[name]
        bits = history_digest(hist) == history_digest(ref[name])
        say("39", f"(c) {name} B=1024 world 1 (mesh=, cuda engine): {len(hist)} iterations, "
                  f"wall {wall:.3f} s; the unsharded loop's history bit for bit: {bits}")
        assert bits and len(hist) == len(ref[name]), name

    world = 2
    tmp = ROOT / "build" / f"chip_smoke_ensemble.{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        mp.spawn(ensemble_rank, args=(world, str(tmp / "store"), str(tmp)), nprocs=world,
                 join=True)
        spawn_wall = time.perf_counter() - t0
        parts = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                parts.append(pickle.load(fh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("39", f"(c) world 2: two ranks spawned (gloo over a FileStore, both on cuda:0), "
              f"{spawn_wall:.1f} s with the spawn")
    for name in ENSEMBLE_STUDIES:
        hist = parts[0][name][0]
        digests = {history_digest(p[name][0]) for p in parts}
        assert len(digests) == 1, f"{name}: the ranks' global histories differ"
        agree, total = agreement(name, one[name][0], hist)
        if name == "dg_per_member":
            rep = dg_replay(hist, device, errs)
            clear = (f"replay through the plain version: {rep['decided']} decisions clear of 4x "
                     f"the bound, {rep['agree']} agree (float64 torch engine "
                     f"{rep['decided64']} / {rep['agree64']}), max|d err| {rep['err']:.3e}")
        elif name == "fd_per_member":
            rep = fd_replay(hist, device, errs)
            clear = (f"replay through the plain version: {rep['decided']} decisions clear of 4x "
                     f"the tolerance, {rep['agree']} agree, max|d err| {rep['err']:.3e}")
        else:
            rep = ensemble_replay(hist, device, errs)
            clear = (f"replay through the plain version: {rep['decided']} bisections clear of 4x "
                     f"the bound, {rep['agree']} agree, max|d err_mean| {rep['err']:.3e} "
                     f"(worst {rep['share']:.2%} of its bound)")
        wall = max(p[name][1] for p in parts)
        say("39", f"(c) {name} B=1024 world 2: {len(hist)} iterations (world 1: "
                  f"{len(one[name][0])}), wall {wall:.3f} s on the slower rank (world 1 "
                  f"{one[name][1]:.3f} s, {wall / one[name][1]:.2f}x); decisions on equal "
                  f"partitions agreeing with world 1: {agree} of {total}; {clear}")


# the data-parallel paths (phase 40): the hp studies at phase 14's shape, the
# fused train steps at the NN path's T1 shape and the recurrent path's T2
# widths, both drivers with --dp, and pipeline_march at D = 2
DP_T1 = dict(s=2, f=500, b=8192, seed=17, init_seed=5, perturb=0.05, steps=2)
DP_T2 = dict(sizes=(100, 500), b=512, s=2, seed=19, init_seed=9, steps=2)
DP_DG_ARGV = ["--ensemble", "1024", "--per-member", "--device-loop"]
DP_PIPE = dict(width=500, s=8, m=4, mb=1024, seed=23, init_seed=11)
DP_LR = 1e-3


def hp_dp_study(kind, device, grid):
    """Phase 14's hp study (B = 512, hp mode, H1) through the loops' mesh=:
    the per-member study on the device loop, or the shared-partition
    ensemble on the host loop (``dg_adaptive --hp hp --ensemble 512``)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop

    sin = odes.get_ode("du/dt=sin(u)")
    y0s = np.random.default_rng(HP_STUDY["seed"]).uniform(0.5, 2.0, HP_STUDY["b"]).astype(
        np.float32)
    kw = dict(f_u=sin.f_u, k0=HP_STUDY["k0"], n0=1, n_max=HP_STUDY["n_max"], mode="hp",
              tol=0.0, maxit=HP_STUDY["maxit"], newton_iters=HP_STUDY["newton_iters"],
              engine="cuda", ode=sin, dtype=torch.float32, device=device, mesh=grid)
    if kind == "hp_per_member":
        return hp_loop.run_adaptive_dg_hp_per_member(sin.f, y0s, (0.0, HP_STUDY["t1"]),
                                                     device_loop=True, **kw)
    return hp_loop.run_adaptive_dg_hp(sin.f, y0s, (0.0, HP_STUDY["t1"]), **kw)


def dp_train(kind, device, grid):
    """Two Adam steps of a fused train step through mesh= (None: the
    unsharded step): T1 at the NN path's shape (ResBlockSimple(500), S = 2,
    8192 members) or T2 at the recurrent path's widths (100, 500), S = 2,
    B = 512. Returns (losses, parameters on the host)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple, ResNetBlock
    from adjoint_ode_adaptivity_tpu_torch.train import loop

    cfg = DP_T1 if kind == "t1" else DP_T2
    gen = torch.Generator().manual_seed(cfg["init_seed"])
    s = cfg["s"]
    if kind == "t1":
        one = ResBlockSimple(cfg["f"]).init_params(gen)
        params = {k: (torch.stack([v] * s) + cfg["perturb"] * torch.randn((s,) + v.shape,
                                                                           generator=gen)
                      ).to(device) for k, v in one.items()}
    else:
        params = ResNetBlock(cfg["sizes"]).init_params(gen, device=device)
    u0 = torch.tensor(np.random.default_rng(cfg["seed"]).uniform(0.5, 2.0, cfg["b"]),
                      dtype=torch.float32, device=device)
    tr = odes.get_ode("du/dt=sin(u)").exact_fwd(1.0, u0).to(torch.float32)
    dt = torch.full((s,), 1.0 / s, dtype=torch.float32, device=device)
    tx = loop.Adam(DP_LR)
    state = loop.create_train_state(params, tx)
    losses = []
    if kind == "t1":
        step = loop.make_per_step_train_step_fused(tx, s, cfg["f"], device=device, mesh=grid)
        for _ in range(cfg["steps"]):
            state, loss = step(state, dt, u0, tr)
            losses.append(float(loss))
    else:
        step = loop.make_shared_train_step_fused(tx, dt, cfg["sizes"], device=device, mesh=grid)
        for _ in range(cfg["steps"]):
            state, loss = step(state, u0, tr)
            losses.append(float(loss))
    return losses, {k: v.detach().cpu() for k, v in _flat_leaves(state.params)}


def _flat_leaves(tree, prefix=""):
    """(name, tensor) of a nested dict of tensors, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def dp_pipeline(device, grid):
    """pipeline_march of ResBlockSimple(500) steps (float64, S = 8, M = 4
    microbatches of 1024 members) over ``grid``'s pipe axis against the
    single-process march on the same card: (finals, the gradient of Σ
    finals² joined over the ranks, the march's finals, its gradient, the
    host wall s of the pipeline's forward and backward alone)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.fd import forward_march_per_step
    from adjoint_ode_adaptivity_tpu_torch.models import ResBlockSimple
    from adjoint_ode_adaptivity_tpu_torch.parallel import all_reduce_sum, pipeline_march

    c = DP_PIPE
    net = ResBlockSimple(c["width"])
    gen = torch.Generator().manual_seed(c["init_seed"])
    one = net.init_params(gen, dtype=torch.float64)
    params = {k: (torch.stack([v * (1 + 0.01 * i) for i in range(c["s"])])).to(device)
              for k, v in one.items()}
    dt = torch.full((c["s"],), 1.0 / c["s"], dtype=torch.float64, device=device)
    u0s = torch.tensor(np.random.default_rng(c["seed"]).uniform(-2, 2, (c["m"], c["mb"])),
                       device=device)

    def step(u, t, d, p):  # (mb,) scalar states as (mb, 1)
        return net(p, u[:, None], t, d)[:, 0]

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finals = pipeline_march(step, grid)(leaves, dt, u0s)
    torch.sum(finals ** 2).backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grads = {k: all_reduce_sum(v.grad, grid, "pipe") for k, v in leaves.items()}
    ref = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = torch.stack([forward_march_per_step(step, u0s[j], dt, ref)[-1]
                        for j in range(c["m"])])
    torch.sum(want ** 2).backward()
    return finals.detach(), grads, want.detach(), {k: v.grad for k, v in ref.items()}, wall


def dp_driver(name):
    """One driver with --dp (one rank, or the ranks of the launch that
    called): ``dg_adaptive --ensemble 1024 --per-member --device-loop``
    (D1; returns its history and printed lines) or the NN path (T1;
    returns its grid, parameters and printed lines)."""
    import io
    from contextlib import redirect_stdout

    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive, train_resnet_ode

    buf = io.StringIO()
    with redirect_stdout(buf):
        if name == "dg_driver":
            out = (dg_adaptive.main(DP_DG_ARGV + ["--dp"]),)
        else:
            state, times = train_resnet_ode.main(NN_ARGV + ["--dp", "--quiet"])
            out = (times.cpu(), {k: v.detach().cpu() for k, v in state.params.items()})
    return out + (buf.getvalue().splitlines(),)


DP_CASES = ("hp_per_member", "hp_ensemble", "t1", "t2", "dg_driver", "nn_driver", "pipeline")


def dp_cases(device, data, pipe, sync):
    """Every phase-40 case on this rank's grids (``data`` for the studies
    and the train steps, ``pipe`` for the pipeline; the drivers make their
    own): name -> (result, wall s, {kernel: launches on this rank}). Each
    case runs once to warm up and once timed (a fresh rank's first run of
    the NN driver pays start-up costs many times its warm wall)."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

    counters = {"H1": hm.dg_estimate_hp_per_member, "D1": ds.dg_estimate_ensemble,
                "T1": tf.resblock_epoch_grad, "T2": td.dense_epoch_grad}
    runs = {"hp_per_member": lambda: hp_dp_study("hp_per_member", device, data),
            "hp_ensemble": lambda: hp_dp_study("hp_ensemble", device, data),
            "t1": lambda: dp_train("t1", device, data),
            "t2": lambda: dp_train("t2", device, data),
            "dg_driver": lambda: dp_driver("dg_driver"),
            "nn_driver": lambda: dp_driver("nn_driver"),
            "pipeline": lambda: dp_pipeline(device, pipe)}
    out = {}
    for name in DP_CASES:
        runs[name]()
        sync()
        for module in (hm, ds, tf, td):
            module.reset_launch_counts()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = (res, wall, {k: c.launches for k, c in counters.items() if c.launches})
    return out


def dp_rank(rank, world, port, out_dir):
    """One rank of phase 40's world 2 (torch.multiprocessing.spawn): the
    torchrun environment, then ``parallel.init_dp_grid`` as the drivers'
    --dp joins (gloo: both ranks on cuda:0); every case's result, wall and
    launches go to out_dir/rank{r}.pkl."""
    sys.path.insert(0, str(ROOT))
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from adjoint_ode_adaptivity_tpu_torch.parallel import init_dp_grid, make_rank_grid

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        grid, device = init_dp_grid({"data": -1}, "cuda")
        assert grid.backend == "gloo" and device == torch.device("cuda", 0), (grid, device)
        out = dp_cases(device, grid, make_rank_grid({"pipe": world}), dist.barrier)
        out = {k: (_host(v[0]), v[1], v[2]) for k, v in out.items()}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _host(x):
    """``x`` with every tensor moved to the host (to pickle it)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_host(v) for v in x)
    return x


def hp_ensemble_replay(hist, device, errs):
    """Every iteration's shared partition and orders of the B = 512 hp
    ensemble study through H1's plain version (float32, same card): the
    history's signed mean err within the mean of the per-element bounds
    plus the float32 sum's B·ε·mean|err|, and the element the study refined
    (p or h) the plain signal's argmax where its top-two margin clears 4x
    the largest bound (a gate)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    sin = odes.get_ode("du/dt=sin(u)")
    b = HP_STUDY["b"]
    plan = hp_kernel(sin, HP_STUDY["n_max"], HP_STUDY["fo"], HP_K, "solve", device).plan
    y0 = torch.tensor(np.random.default_rng(HP_STUDY["seed"]).uniform(0.5, 2.0, b).astype(
        np.float32), device=device)
    out = dict(decided=0, agree=0, err=0.0, share=0.0)
    for r, nxt in zip(hist, list(hist[1:]) + [None]):
        na = len(r.ns)
        t = np.concatenate([r.times, np.full(HP_K + 1 - len(r.times), r.times[-1])])
        n = np.concatenate([r.ns, np.ones(HP_K - na, np.int64)])
        times = torch.tensor(t, dtype=torch.float32, device=device)[None].expand(b, -1).contiguous()
        ns = torch.tensor(n, dtype=torch.int64, device=device)[None].expand(b, -1).contiguous()
        plain = hm.dg_estimate_hp_per_member_plain(times, ns, y0, plan)
        tol = hm.hp_kernel_tolerance(times, ns, y0, plain, plan)["err"]
        err_p = plain[3].double()
        bound = tol.mean(0)[:na] + b * EPS32 * err_p.abs().mean(0)[:na]
        d = (torch.tensor(r.err, device=device, dtype=torch.float64) - err_p.mean(0)[:na]).abs()
        assert bool((d <= bound).all()), (float(d.max()), float(bound.max()))
        out["err"] = max(out["err"], float(d.max()))
        out["share"] = max(out["share"], float((d / bound.clamp_min(1e-300)).max()))
        if nxt is None or (len(nxt.ns) == na and np.array_equal(nxt.ns, r.ns)):
            continue
        if len(nxt.ns) == na:  # p: the order that rose
            ref = int(np.flatnonzero(nxt.ns != r.ns)[0])
        else:  # h: the first node that moved is the bisected element's midpoint
            ref = int(np.flatnonzero(nxt.times[: na + 1] != r.times)[0]) - 1
        signal = err_p.abs().mean(0)[:na]
        top2 = torch.topk(signal, 2)
        if float(top2.values[0] - top2.values[1]) > 4 * float(bound.max()):
            out["decided"] += 1
            out["agree"] += int(ref == int(top2.indices[0]))
    errs["dg_estimate_hp_per_member"] = max(errs["dg_estimate_hp_per_member"], out["err"])
    assert out["decided"] > 0 and out["agree"] == out["decided"], out
    return out


def train_close(got, want):
    """tests/test_torch_parallel_dp.py's tolerances (the JAX package's fused
    train tests'): the losses within rtol 1e-6, every parameter within rtol
    1e-4, atol 1e-7. Returns (worst loss rtol, worst parameter excess over
    its tolerance, ok)."""
    import torch

    (l_got, p_got), (l_want, p_want) = got, want
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_got, l_want))
    excess = max(float(((p_got[k].double() - p_want[k].double()).abs()
                        - (1e-7 + 1e-4 * p_want[k].double().abs())).max()) for k in p_want)
    return loss_rel, excess, loss_rel <= 1e-6 and excess <= 0


def same_bits(a, b):
    """Two results (nested tuples, lists, dicts, tensors, arrays, numbers,
    namedtuple histories) equal bit for bit."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def phase40(device, errs):
    """The data- and pipeline-parallel paths: the hp studies' mesh= (H1),
    the fused train steps' mesh= (T1, T2), both drivers' --dp (D1, T1) and
    pipeline_march at D = 2. World 1 in this process (a one-rank grid: the
    unsharded bits), world 2 as two gloo ranks on cuda:0 joined through
    the torchrun environment and init_dp_grid; each case's wall and its
    kernels' launches a rank; every hp decision clear of 4x the kernel's
    bound replayed through the plain version."""
    import pickle
    import shutil
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from adjoint_ode_adaptivity_tpu_torch.parallel import make_rank_grid

    one = dp_cases(device, make_rank_grid({"data": 1}), make_rank_grid({"pipe": 1}),
                   lambda: None)
    for name in ("hp_per_member", "hp_ensemble"):
        ref = hp_dp_study(name, device, None)
        bits = history_digest(one[name][0]) == history_digest(ref)
        say("40", f"(a) {name} B={HP_STUDY['b']} world 1 (mesh=, H1): {len(ref)} iterations, wall "
                  f"{one[name][1]:.3f} s, launches {one[name][2]}; the unsharded loop's "
                  f"history bit for bit: {bits}")
        assert bits and len(one[name][0]) == len(ref), name
    for name in ("t1", "t2"):
        ref = dp_train(name, device, None)
        bits = same_bits(one[name][0], ref)
        say("40", f"(b) {name.upper()} step world 1 (mesh=): losses {one[name][0][0]}, wall "
                  f"{one[name][1]:.3f} s, launches {one[name][2]}; the unsharded step's bits: "
                  f"{bits}")
        assert bits, name
    finals, grads, want, want_g, pipe_s = one["pipeline"][0]
    bits = torch.equal(finals, want)
    g_rel = max(float(((grads[k] - want_g[k]).abs() / want_g[k].abs().clamp_min(1e-300)).max())
                for k in grads)
    c = DP_PIPE
    say("40", f"(d) pipeline_march D=1 (ResBlockSimple({c['width']}), S={c['s']}, M={c['m']} x "
              f"{c['mb']}, float64): forward and backward {pipe_s:.3f} s (the case with the "
              f"reference march {one['pipeline'][1]:.3f} s); the single-process march's finals "
              f"bit for bit: "
              f"{bits}, gradients max rel diff {g_rel:.2e}")
    assert bits and g_rel <= 1e-10

    world = 2
    tmp = ROOT / "build" / f"chip_smoke_dp.{time.time_ns()}"
    tmp.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(world, port, str(tmp)), nprocs=world, join=True)
        spawn_wall = time.perf_counter() - t0
        parts = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                parts.append(pickle.load(fh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("40", f"world 2: two ranks spawned with the torchrun environment (init_dp_grid: gloo, "
              f"both on cuda:0), {spawn_wall:.1f} s with the spawn")
    for name in DP_CASES:
        for p in parts:  # not the drivers' lines (rank 0 alone prints) nor the pipeline's wall
            got, want = p[name][0], parts[0][name][0]
            if name.endswith("_driver") or name == "pipeline":
                got, want = got[:-1], want[:-1]
            assert same_bits(got, want), f"{name}: the ranks' results differ"
    launches = {name: [p[name][2] for p in parts] for name in DP_CASES}
    walls = {name: max(p[name][1] for p in parts) for name in DP_CASES}
    for name, kernel in (("hp_per_member", "H1"), ("hp_ensemble", "H1"), ("t1", "T1"),
                         ("t2", "T2"), ("dg_driver", "D1"), ("nn_driver", "T1")):
        assert all(n.get(kernel, 0) > 0 for n in launches[name]), (name, kernel, launches[name])

    hist = parts[0]["hp_per_member"][0]
    rep = hp_replay(hist, "solve", device, errs)
    agree, total = agreement("dg_per_member", one["hp_per_member"][0], hist)
    say("40", f"(a) hp_per_member world 2: {len(hist)} iterations (world 1 "
              f"{len(one['hp_per_member'][0])}), wall {walls['hp_per_member']:.3f} s on the "
              f"slower rank (world 1 {one['hp_per_member'][1]:.3f} s), launches a rank "
              f"{launches['hp_per_member']}; decisions on equal partitions agreeing with world "
              f"1: {agree} of {total}; replay through the plain version: {rep['decided']} "
              f"decisions clear of 4x the bound, {rep['agree']} agree (float64 torch engine "
              f"{rep['decided64']} / {rep['agree64']}), max|d err| {rep['err']:.3e}")
    hist = parts[0]["hp_ensemble"][0]
    rep = hp_ensemble_replay(hist, device, errs)
    same = sum(np.array_equal(a.times, b.times) and np.array_equal(a.ns, b.ns)
               for a, b in zip(one["hp_ensemble"][0], hist))
    say("40", f"(a) hp_ensemble world 2: {len(hist)} iterations, K {len(hist[0].ns)} -> "
              f"{len(hist[-1].ns)}, wall {walls['hp_ensemble']:.3f} s (world 1 "
              f"{one['hp_ensemble'][1]:.3f} s), launches a rank {launches['hp_ensemble']}; "
              f"{same} of {len(hist)} iterations on world 1's partition and orders; replay: "
              f"{rep['decided']} refinements clear of 4x the bound, {rep['agree']} agree, "
              f"max|d err| {rep['err']:.3e} (worst {rep['share']:.2%} of its bound)")
    for name in ("t1", "t2"):
        loss_rel, excess, ok = train_close(parts[0][name][0], one[name][0])
        say("40", f"(b) {name.upper()} step world 2: losses {parts[0][name][0][0]}, wall "
                  f"{walls[name]:.3f} s (world 1 {one[name][1]:.3f} s), launches a rank "
                  f"{launches[name]}; parameters bit-identical on both ranks; against world 1 "
                  f"loss rel diff {loss_rel:.2e} (limit 1e-6), parameters {excess:+.2e} over "
                  f"rtol 1e-4 + atol 1e-7 (ok: {ok})")
        assert ok, name
    dg2, lines2 = parts[0]["dg_driver"][0]
    dg1, lines1 = one["dg_driver"][0]
    rep = dg_replay(dg2, device, errs)
    agree, total = agreement("dg_per_member", dg1, dg2)
    say("40", f"(c) dg_adaptive {' '.join(DP_DG_ARGV)} --dp: world 1 {len(dg1)} iterations, "
              f"wall {one['dg_driver'][1]:.3f} s; world 2 {len(dg2)}, wall "
              f"{walls['dg_driver']:.3f} s ({lines2[0]!r}, rank 1 printed "
              f"{len(parts[1]['dg_driver'][0][-1])} lines), launches a rank "
              f"{launches['dg_driver']}; decisions on equal partitions agreeing with world 1: "
              f"{agree} of {total}; replay: {rep['decided']} decisions clear of 4x the bound, "
              f"{rep['agree']} agree")
    assert lines1[0] == "dp over 1 devices" and lines2[0] == "dp over 2 devices"
    assert not parts[1]["dg_driver"][0][-1] and not parts[1]["nn_driver"][0][-1]
    t2, _, nn_lines2 = parts[0]["nn_driver"][0]
    t1, _, nn_lines1 = one["nn_driver"][0]
    say("40", f"(c) train_resnet_ode {' '.join(NN_ARGV)} --dp: world 2 grid {t2.tolist()} "
              f"(world 1 {t1.tolist()}, equal: {torch.equal(t1, t2)}); {nn_lines2[-1]!r}; both "
              f"ranks the same grid and parameters; wall {walls['nn_driver']:.3f} s (world 1 "
              f"{one['nn_driver'][1]:.3f} s), launches a rank "
              f"{launches['nn_driver']}")
    assert nn_lines1[0] == "dp over 1 devices" and nn_lines2[0] == "dp over 2 devices"
    assert t1.shape == t2.shape and float((t1 - t2).abs().max()) <= 1e-6
    finals, grads, want, want_g, _ = parts[0]["pipeline"][0]
    pipe_s = max(p["pipeline"][0][4] for p in parts)
    f_rel = float(((finals - want).abs() / want.abs().clamp_min(1e-300)).max())
    g_rel = max(float(((grads[k] - want_g[k]).abs() / want_g[k].abs().clamp_min(1e-300)).max())
                for k in grads)
    say("40", f"(d) pipeline_march D=2: forward and backward {pipe_s:.3f} s on the slower rank "
              f"(D=1 {one['pipeline'][0][4]:.3f} s; the case with the reference march "
              f"{walls['pipeline']:.3f} s); finals against the single-process march max rel "
              f"diff {f_rel:.2e} (limit 1e-12), gradients {g_rel:.2e} (limit 1e-10)")
    assert f_rel <= 1e-12 and g_rel <= 1e-10


# ------------------------------------------------- the IFT marches and host tools

IFT_SLABS = 16
IFT_BATCH = dict(b=16_384, width=32, steps=5, lr=1e-2, newton_iters=8, seed=41)
IFT_CHECK_B = 256  # the members whose steps are held against the CPU
IFT_TOL = 1e-10  # card against CPU, float64: relative to the largest entry
FACADE = dict(steps=10_000, adjoint_steps=2_500)  # the fine adjoint march: 10^4 steps at rf 4
SWEEP_EXTRA = "--device cuda --maxit 5"


def rel(a, b) -> float:
    """max |a − b| / max |b| over tensors or dicts of tensors on any devices."""
    import torch

    if isinstance(a, dict):
        return max(rel(a[k], b[k]) for k in a)
    a, b = (torch.as_tensor(x).detach().double().cpu() for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def ift_grads(march, dev, y0, p, times, objective):
    """``march(times, y0, p)`` (float64 on ``dev``), its objective and the
    objective's gradients with respect to (y0, p, times)."""
    import torch

    leaves = [torch.tensor(x, dtype=torch.float64, device=dev, requires_grad=True)
              for x in (y0, p, times)]
    u = march(leaves[2], leaves[0], leaves[1])
    j = objective(u)
    return u.detach(), j.detach(), torch.autograd.grad(j, leaves)


def ift_single(device):
    """41(a): dg_march_differentiable, N = 2, 16 slabs, f = sin(p·u)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import (
        dg_march,
        dg_march_differentiable,
        dg_time_operators,
    )

    ops = dg_time_operators(2)
    times = np.linspace(0.0, 2.0, IFT_SLABS + 1)

    def march(ts, y0, p):
        return dg_march_differentiable(ops, lambda u, t, q: torch.sin(q * u), ts, y0, p)

    def objective(u):
        return (u[-1] ** 2).sum() + u[:, 0].sum()

    t0 = time.perf_counter()
    u_c, j_c, g_c = ift_grads(march, device, 1.0, 1.3, times, objective)
    wall = time.perf_counter() - t0
    _, j_h, g_h = ift_grads(march, "cpu", 1.0, 1.3, times, objective)
    plain = dg_march(ops, lambda u, t: torch.sin(1.3 * u),
                     torch.tensor(times, dtype=torch.float64, device=device), 1.0).u
    val_err = float((u_c - plain).abs().max())
    g_rel = [rel(a, b) for a, b in zip(g_c, g_h)]
    eps = 1e-6

    def j_at(y0, p, ts):
        u = march(torch.tensor(ts, dtype=torch.float64, device=device), y0, p)
        return float(objective(u))

    bumped = times.copy()
    bumped[5] += eps
    lowered = times.copy()
    lowered[5] -= eps
    fd = ((j_at(1.0 + eps, 1.3, times) - j_at(1.0 - eps, 1.3, times)) / (2 * eps),
          (j_at(1.0, 1.3 + eps, times) - j_at(1.0, 1.3 - eps, times)) / (2 * eps),
          (j_at(1.0, 1.3, bumped) - j_at(1.0, 1.3, lowered)) / (2 * eps))
    ad = (float(g_c[0]), float(g_c[1]), float(g_c[2][5]))
    fd_rel = max(abs(a - b) / abs(b) for a, b in zip(ad, fd))
    say("41", f"(a) dg_march_differentiable N=2, K={IFT_SLABS}, f=sin(p u), float64 on the card: "
              f"values against dg_march max |diff| {val_err:.2e} (limit 1e-12); J {float(j_c):.12f}"
              f", d/d(y0, p, times) against the CPU's max rel diff {max(g_rel):.2e} (limit 1e-10)"
              f", against central differences (eps 1e-6; y0, p, t_5) max rel "
              f"{fd_rel:.2e} (limit 1e-6); forward and backward {wall:.3f} s (a host read a "
              f"Newton step)")
    assert val_err <= 1e-12 and max(g_rel) <= 1e-10 and rel(j_c, j_h) <= 1e-12 and fd_rel <= 1e-6


def ift_mlp(u, t, p):
    """The tanh MLP right-hand side u -> tanh(u·w1 + b1)·w2, elementwise."""
    import torch

    h = torch.tanh(u[..., None] * p["w1"][0] + p["b1"])
    return (h @ p["w2"])[..., 0]


def ift_problem(n, dev, b):
    """41(b)'s training problem at order ``n`` on ``dev`` over the first
    ``b`` members: (loss(params), march(f, params) -> u(T)), the loss the
    mean squared distance of u(T) from the sin(u) flow's, both through the
    solver; and the initial parameters (float64 on ``dev``)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_batched import (
        dg_march_batched_differentiable,
    )
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators

    c = IFT_BATCH
    rng = np.random.default_rng(c["seed"])
    init = {"w1": rng.normal(size=(1, c["width"])) * 0.5, "b1": np.zeros(c["width"]),
            "w2": rng.normal(size=(c["width"], 1)) * 0.2}
    y0s = rng.uniform(0.5, 2.0, b)  # the first b of any larger draw
    ops = dg_time_operators(n)
    y = torch.tensor(y0s[:b], dtype=torch.float64, device=dev)
    ts = torch.linspace(0.0, 2.0, IFT_SLABS + 1, dtype=torch.float64, device=dev)

    def march(f, p=None):
        return dg_march_batched_differentiable(ops, f, ts, y, p,
                                               newton_iters=c["newton_iters"])[:, -1, -1]

    target = march(lambda u, t, p: torch.sin(u))
    params = {k: torch.tensor(v, dtype=torch.float64, device=dev) for k, v in init.items()}
    return (lambda p: torch.mean((march(ift_mlp, p) - target) ** 2)), march, params


def ift_train(n, dev, b) -> list:
    """IFT_BATCH's Adam steps from the seed's draws: [(params, loss,
    gradients)] a step."""
    from adjoint_ode_adaptivity_tpu_torch import train

    loss, _, params = ift_problem(n, dev, b)
    tx = train.Adam(IFT_BATCH["lr"])
    state, steps = tx.init(params), []
    for _ in range(IFT_BATCH["steps"]):
        val, g = train.value_and_grad(loss, params)
        steps.append((params, val, g))
        params, state = tx.update(g, state, params)
    return steps


def ift_cpu_steps() -> dict:
    """41(b)'s CPU reference, in a process of its own while the card runs
    the phase: each order's steps of the first IFT_CHECK_B members (float64),
    their losses and gradients."""
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(2)  # beside the phase's own process and the sweep's two
    return {n: [(float(v), g) for _, v, g in ift_train(n, "cpu", IFT_CHECK_B)] for n in (1, 2)}


def ift_batched(device) -> dict:
    """41(b): a width-32 tanh MLP right-hand side trained through
    dg_march_batched_differentiable at B = 16,384, 16 slabs, N = 1 and 2.
    Returns each order's steps over the first IFT_CHECK_B members on the
    card, to hold against ift_cpu_steps."""
    import torch

    c = IFT_BATCH
    checks = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        steps = ift_train(n, device, c["b"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        losses = [float(v) for _, v, _ in steps]
        loss, march, _ = ift_problem(n, device, c["b"])
        params = steps[-1][0]

        def fwd_bwd(p=params):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            return torch.autograd.grad(loss(leaves), list(leaves.values()))

        fwd, bwd = [], []
        for _ in range(3):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            val = loss(leaves)
            ev[1].record()
            torch.autograd.grad(val, list(leaves.values()))
            ev[2].record()
            torch.cuda.synchronize()
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
        ms_f, ms_b = statistics.median(fwd), statistics.median(bwd)
        say("41", f"(b) N={n}: B={c['b']}, {IFT_SLABS} slabs, {c['newton_iters']} Newton steps, "
                  f"tanh MLP width {c['width']}, float64, {c['steps']} Adam steps (lr {c['lr']}) in "
                  f"{train_s:.3f} s (problem set-up included), losses "
                  f"{[f'{v:.6e}' for v in losses]}; a step's forward + backward "
                  f"{ms_f + ms_b:.3f} ms (CUDA events, median of 3; forward {ms_f:.3f}, backward "
                  f"{ms_b:.3f}, {ms_b / (ms_f + ms_b):.1%})")
        study_trace(fwd_bwd, "tanh", phase="41")
        assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
        checks[n] = [(float(v), g) for _, v, g in ift_train(n, device, IFT_CHECK_B)]
        _, march_c, _ = ift_problem(n, device, IFT_CHECK_B)
        with torch.no_grad():
            tie = rel(march(ift_mlp, params)[:IFT_CHECK_B], march_c(ift_mlp, params))
        say("41", f"(b) N={n}: u(T) of the first {IFT_CHECK_B} members in the B={c['b']} march "
                  f"against the {IFT_CHECK_B}-member march at the last step's parameters: max rel "
                  f"diff {tie:.2e} (limit 1e-12)")
        assert tie <= 1e-12
    return checks


def ift_compare(card: dict, cpu: dict) -> None:
    """41(b)'s gate: the card's steps of the first IFT_CHECK_B members
    against the CPU's, loss and gradients at every step."""
    for n in card:
        worst_v = max(rel(a[0], b[0]) for a, b in zip(card[n], cpu[n]))
        worst_g = max(rel(a[1], b[1]) for a, b in zip(card[n], cpu[n]))
        say("41", f"(b) N={n}: the {len(card[n])} Adam steps of the first {IFT_CHECK_B} members, "
                  f"card against CPU (float64, each from the seed's draws): every step's loss max "
                  f"rel diff {worst_v:.2e}, gradients {worst_g:.2e} (limit {IFT_TOL:.0e})")
        assert len(card[n]) == len(cpu[n]) == IFT_BATCH["steps"]
        assert worst_v <= IFT_TOL and worst_g <= IFT_TOL


def ift_mixed(device):
    """41(c): dg_march_mixed_differentiable on orders 1-4 over 16 elements."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import (
        dg_march_mixed,
        dg_march_mixed_differentiable,
        dg_time_operators_mixed,
    )

    mops = dg_time_operators_mixed(4)
    times = np.linspace(0.0, 2.0, IFT_SLABS + 1)
    ns = np.tile([1, 2, 3, 4], IFT_SLABS // 4)

    def march(ts, y0, p):
        return dg_march_mixed_differentiable(mops, lambda u, t, q: torch.sin(u) * q, ts, ns, y0,
                                             p)

    def objective(u):
        return u[:, 0].sum() + u[-1].sum()

    u_c, j_c, g_c = ift_grads(march, device, 1.0, 1.3, times, objective)
    _, _, g_h = ift_grads(march, "cpu", 1.0, 1.3, times, objective)
    ts = torch.tensor(times, dtype=torch.float64, device=device)
    plain = dg_march_mixed(mops, lambda u, t: torch.sin(u) * 1.3, ts[None],
                           torch.tensor(ns, device=device)[None],
                           torch.ones(1, dtype=torch.float64, device=device)).u[0]
    val_err = float((u_c - plain).abs().max())
    g_rel = max(rel(a, b) for a, b in zip(g_c, g_h))
    say("41", f"(c) dg_march_mixed_differentiable orders {ns.tolist()}, f=sin(u) p, float64 on "
              f"the card: values against dg_march_mixed max |diff| {val_err:.2e} (limit 1e-12); "
              f"d/d(y0, p, times) against the CPU's max rel diff {g_rel:.2e} (limit 1e-10)")
    assert val_err <= 1e-12 and g_rel <= 1e-10


def facade(device):
    """41(d): every Funs field of get_problem_functions on the card against
    device='cpu', du/dt=sin(u), J=int(u^2)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import config

    problem = config.Problem(case="smoke", ode="du/dt=sin(u)", out_functional="J=int(u^2)")
    card, host = (config.get_problem_functions(problem, device=d) for d in (device, "cpu"))
    rng = np.random.default_rng(7)

    def grid(n):
        w = rng.uniform(0.5, 1.5, n)
        dt = w / w.sum() * 2.0
        return dt, np.concatenate([[0.0], np.cumsum(dt)])

    dt, t = grid(FACADE["steps"])
    dt_a, t_a = grid(FACADE["adjoint_steps"])
    t0 = time.perf_counter()
    # the CPU's forward, adjoint and estimate are the card's inputs and its references
    want = {"forward_solve": host.forward_solve(dt)}
    u = want["forward_solve"].numpy()
    u_a = host.forward_solve(dt_a).numpy()
    want["adjoint_solve"] = host.adjoint_solve(dt_a, u_a)
    v_a = want["adjoint_solve"].numpy()
    want["error_estimate"] = host.error_estimate(dt_a, u_a, v_a)
    err = want["error_estimate"].numpy()
    T = lambda x, d: torch.tensor(x, dtype=torch.float64, device=d)  # noqa: E731
    fields = {
        "fwd_update": lambda F, d: F.fwd_update(T(u[:-1], d), T(t[:-1], d), T(dt, d)),
        "get_f": lambda F, d: F.get_f(u, dt),
        "get_jf_diag": lambda F, d: F.get_jf_diag(u, dt),
        "get_k": lambda F, d: F.get_k(u, dt),
        "exact_fwd": lambda F, d: F.exact_fwd(T(t, d), 1.0),
        "exact_adj": lambda F, d: F.exact_adj(t[::50]),
        "forward_solve": lambda F, d: F.forward_solve(dt),
        "adjoint_solve": lambda F, d: F.adjoint_solve(dt_a, u_a),
        "error_estimate": lambda F, d: F.error_estimate(dt_a, u_a, v_a),
        "adapt": lambda F, d: F.adapt(t_a, err),
    }
    assert set(fields) == set(config.Funs._fields)
    diffs = {}
    for name, fn in fields.items():
        got = fn(card, device)
        ref = want[name] if name in want else fn(host, "cpu")
        assert got.device.type == device.type and ref.device.type == "cpu", name
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        diffs[name] = float((got.cpu() - ref).abs().max() / max(1.0, float(ref.abs().max())))
    wall = time.perf_counter() - t0
    say("41", f"(d) get_problem_functions(device=cuda) against device=cpu, du/dt=sin(u), "
              f"J=int(u^2), {FACADE['steps']} steps ({FACADE['adjoint_steps']} coarse, "
              f"{FACADE['adjoint_steps'] * problem.ref_factor} fine for the adjoint fields): max "
              f"|diff|/max(1, |cpu|) per field {', '.join(f'{k} {v:.1e}' for k, v in diffs.items())}"
              f" (limit 1e-12); both devices {wall:.2f} s")
    assert max(diffs.values()) <= 1e-12, diffs


def host_tools(device):
    """41(e): ops/io at K = 10^4 and profiling.trace around one
    stored-pipeline estimate."""
    import shutil

    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops import io, startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs
    from adjoint_ode_adaptivity_tpu_torch.utils import profiling

    tmp = ROOT / "build" / f"chip_smoke_tools.{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        disc = startup_1d(2, 0.0, 2 * np.pi, 10_000)
        path = io.save_discretization(disc, tmp / "disc.npz")
        back = io.load_discretization(path)
        same = all(
            (type(b) is int and a == b) if isinstance(a, int) else
            (np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b))
            for a, b in zip(disc, back))
        say("41", f"(e) ops/io: Discretization1D K=10^4, N=2 through {path.name} "
                  f"({path.stat().st_size} bytes): every field bit for bit {same}")
        assert same

        n_order, k, n_steps, b = (HEADLINE[x] for x in ("n_order", "k", "n_steps", "batch"))
        hd = mesh(n_order, k, graded=False)
        run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(hd, A, cfl_step(hd), n_steps, b,
                                                             device, store_trajectory=True)
        u0 = phased_states(hd, b, device, torch.float32)
        lam = batched_cotangent(hd, b, device, torch.float32)
        run(u0, 0.0, lam)
        torch.cuda.synchronize()
        with profiling.trace(str(tmp / "trace")):
            run(u0, 0.0, lam)
            torch.cuda.synchronize()
        ran = dg_rhs.fwd_march.cuda_launches + dg_rhs.adj_est_stored.cuda_launches
        (trace_file,) = list((tmp / "trace").iterdir())
        events = json.loads(trace_file.read_text())["traceEvents"]
        recorded = sum(1 for e in events if e.get("cat") == "kernel")
        say("41", f"(e) profiling.trace around one stored-pipeline estimate (K={k}, N={n_order}, "
                  f"{n_steps} steps, B={b}): {trace_file.name} "
                  f"({trace_file.stat().st_size} bytes), {recorded} kernel launches recorded, "
                  f"{ran} CUDA launches ran (K1 {dg_rhs.fwd_march.cuda_launches}, K2 "
                  f"{dg_rhs.adj_est_stored.cuda_launches})")
        assert recorded > 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_run(out: dict) -> None:
    """41(e)'s sweep: two fd_adaptive seeds on the card at --parallel 2,
    through the sweep's command line (it raises unless every rc is 0); its
    wall, or the exception, into ``out``."""
    from adjoint_ode_adaptivity_tpu_torch.drivers import sweep

    t0 = time.perf_counter()
    try:
        out["cmds"] = sweep.main(["--driver", "fd_adaptive", "--seeds", "1", "2",
                                  f"--extra={SWEEP_EXTRA}", "--run", "--parallel", "2"])
    except BaseException as exc:  # re-raised by phase41 in the main thread
        out["error"] = exc
    out["wall"] = time.perf_counter() - t0


def phase41(device):
    """The IFT-differentiable DG marches, the config facade and the host
    tools on the card. 41(b)'s CPU reference runs in a process of its own
    and the sweep's two driver processes in a thread from the start, beside
    (a), (c), (d) and (e); (b) times its steps after both processes have
    left the card."""
    import concurrent.futures
    import multiprocessing
    import threading

    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_ref = pool.submit(ift_cpu_steps)
        env = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env) if p)
        swept = {}
        thread = threading.Thread(target=sweep_run, args=(swept,))
        thread.start()
        try:
            ift_single(device)
            ift_mixed(device)
            facade(device)
            host_tools(device)
        finally:
            thread.join()
            if env is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = env
        if "error" in swept:
            raise swept["error"]
        say("41", f"(e) sweep --driver fd_adaptive --seeds 1 2 --extra '{SWEEP_EXTRA}' --run "
                  f"--parallel 2: {len(swept['cmds'])} runs, every rc 0 (sweep raises otherwise), "
                  f"{swept['wall']:.1f} s beside (a), (c)-(e)")
        card_ref = ift_batched(device)
        ift_compare(card_ref, cpu_ref.result())
    say("41", f"phase 41 {time.perf_counter() - t0:.1f} s")


# ------------------- traced user functors on F1, F2, F3, D1 and H1 (phase 42)

TRACED = ("fd_ensemble[traced]", "fd_ensemble_vec[traced]", "fd_estimate_per_member[traced]",
          "dg_estimate_ensemble[traced]", "dg_estimate_hp_per_member[traced]")
# D1 at the per-member study's shape and at bench.py's (B, K, Newton steps,
# seed), both on per-member partitions with zero-width tails
USER_D1_CASES = ((1024, 15, 8, 2), (16_384, 16, 5, 1))
USER_STUDY = dict(maxit=10, hp_maxit=5)  # the traced studies' iterations (device loops)


def user_f(u, t):  # du/dt = u(1 − u) + 0.1·cos(2t): in no registry; y0 in [0.2, 0.8]
    import torch

    return u * (1 - u) + 0.1 * torch.cos(2 * t)


def user_f_u(u, t):  # its hand-written ∂f/∂u (F1 and F3)
    return 1 - 2 * u


def user_g_u(u, t):  # J = ∫log u: g_u = 1/u, singular at H1's zero padding nodes
    return 1.0 / u


def user_sin(u, t):  # du/dt = sin(u) spelled as a callable: f_u derived by Dual<float>
    import torch

    return torch.sin(u)


def vdp_comps(us, t):  # Van der Pol, μ = 1, as tests/test_pallas.py:568-570 writes it
    return (us[1], (1.0 - us[0] * us[0]) * us[1] - us[0])


def vdp_jac(us, t):  # tests/test_pallas.py:571-573, its literal 0.0 skipped by F2
    return ((0.0, 1.0), (-2.0 * us[0] * us[1] - 1.0, 1.0 - us[0] * us[0]))


def rigid_comps(us, t):  # d = 3: Euler's rigid body (Hairer), zeros on J's diagonal
    return (us[1] * us[2], -us[0] * us[2], -0.51 * us[0] * us[1])


def rigid_jac(us, t):
    return ((0.0, us[2], us[1]), (-us[2], 0.0, -us[0]), (-0.51 * us[1], -0.51 * us[0], 0.0))


def coupled_comps(us, t):  # d = 4, F2's cap: two coupled oscillators, one cubic, one forced
    import torch

    return (us[1], -us[0] - 0.1 * us[0] * us[0] * us[0] + 0.2 * (us[2] - us[0]), us[3],
            -us[2] + 0.2 * (us[0] - us[2]) + 0.05 * torch.cos(t))


def coupled_jac(us, t):
    return ((0.0, 1.0, 0.0, 0.0), (-1.2 - 0.3 * us[0] * us[0], 0.0, 0.2, 0.0),
            (0.0, 0.0, 0.0, 1.0), (0.2, 0.0, -1.2, 0.0))


# F2 above d = 2 (phase 42(b)): d -> (name, f_comps, jac_comps)
USER_VECTOR_D = {3: ("rigid body", rigid_comps, rigid_jac),
                 4: ("coupled oscillators", coupled_comps, coupled_jac)}


def functor_ops(*fns) -> tuple:
    """Operations that the callables ``fns`` (each a scalar callable or
    ``(fn, d, jacobian)``) need together: one an IR node of their traces (a
    transcendental, a comparison and a select one each; inputs and
    constants free), a subexpression that two of them share counted once.
    Returns (the operations on u, those on t alone): where every IC shares
    the grid, the second is needed once a node, not once an IC. For an f_u
    that the kernel derives, pass f's closed-form derivative: the least
    work for the pair is f and that, not twice f."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import functor

    ids, on_u = {}, []
    for spec in fns:
        fn, d, jac = spec if isinstance(spec, tuple) else (spec, 0, False)
        local = []
        for op, args in functor.trace(fn, d, jac).nodes:
            if op in ("u", "t"):
                key = (op, args)
            else:
                key = (op, tuple(("node", local[a]) if isinstance(a, int) else ("const", a)
                                 for a in args))
            if key not in ids:
                ids[key] = len(on_u)
                on_u.append(op == "u" or any(on_u[local[a]] for a in args
                                             if isinstance(a, int)))
            local.append(ids[key])
    counted = [dep for key, dep in zip(ids, on_u) if key[0] not in ("u", "t")]
    return sum(counted), len(counted) - sum(counted)


def user_libraries():
    """The user libraries phase 42 runs, built together (threads: each a
    single nvcc -c and a link). Returns {name: KernelLibrary} and the wall
    seconds of the whole build."""
    from concurrent.futures import ThreadPoolExecutor

    from adjoint_ode_adaptivity_tpu_torch import odes
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import scalar_functors, vector_functors

    fd = "fd_ensemble.cu"
    kfs = {
        "F1/F3 (f, f_u)": scalar_functors(f=user_f, f_u=user_f_u, source=fd, goal=False,
                                          need_f_u=True),
        "F3 (the study's ode_f, f_u derived)": scalar_functors(
            odes.ODEProblem("ode_f", f=user_f), source=fd, goal=False),
        "F2 (Van der Pol)": vector_functors(f_comps=vdp_comps, jac_comps=vdp_jac, d=2,
                                            source=fd),
        **{f"F2 ({name} d={d})": vector_functors(f_comps=comps, jac_comps=jac, d=d, source=fd)
           for d, (name, comps, jac) in USER_VECTOR_D.items()},
        "D1 (f, g_u = 1/u)": scalar_functors(f=user_f, g_u=user_g_u, source="dg_slab.cu"),
        "D1 (sin(u) as a callable)": scalar_functors(f=user_sin, source="dg_slab.cu"),
        "H1 (f, g_u = 1/u)": scalar_functors(f=user_f, g_u=user_g_u,
                                             source="dg_slab_mixed.cu"),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kfs)) as pool:
        libs = dict(zip(kfs, pool.map(lambda kf: kf.library(), kfs.values())))
    return libs, time.perf_counter() - t0


def user_d1_inputs(device, b, k, seed):
    """y0 ~ U(0.2, 0.8) and per-member partitions of [0, 2] with 2..k−3
    live slabs and zero-width tails, from ``default_rng(seed)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y0 = torch.tensor(rng.uniform(0.2, 0.8, b), dtype=torch.float32, device=device)
    t = np.full((b, k + 1), DG_SLAB["t1"])
    for m, n_act in enumerate(rng.integers(2, k - 3, b)):
        t[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.uniform(0.0, DG_SLAB["t1"], n_act - 1)), [DG_SLAB["t1"]]])
    return torch.tensor(t, dtype=torch.float32, device=device), y0


def user_turns(label, traced, registry):
    """The traced and the registry kernel at one shape in turns (CUDA
    events, median of 5 each, A B B A). Returns the traced kernel's ms."""
    turns = in_turns({"traced": traced, "registry": registry})
    ms, ms_r = (statistics.mean(turns[x]) for x in ("traced", "registry"))
    say("42", f"{label}: in turns traced {ms:.4f} ms ({turns['traced'][0]:.4f} / "
              f"{turns['traced'][1]:.4f}) against the registry kernel {ms_r:.4f} ms "
              f"({turns['registry'][0]:.4f} / {turns['registry'][1]:.4f}), {ms / ms_r:.3f}x")
    return ms


def user_fd(device, inp, errs):
    """Phase 42(b): F1 and F2 at 102,400 ICs and F3 at the per-member
    study's shape on the traced functors, each within fd_kernel_tolerance
    of its plain version with some plain entry above the bound, timed in
    turns beside the registry kernel at the same shape; the registry F1, F2
    and F3 bits against the parent's digests. Returns {name: (ms, plain
    ms)} and the inputs of the path runs."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    n, s, rf, dt = (FD_ENSEMBLE[k] for k in ("n_ics", "n_steps", "rf", "dt"))
    f32 = dict(dtype=torch.float32, device=device)
    u0 = torch.tensor(np.random.default_rng(42).uniform(0.2, 0.8, n), **f32)
    u0v = torch.tensor(np.random.default_rng(43).uniform(-1.5, 1.5, (n, 2)), **f32)
    dt_pm = inp["dt_pm"]
    u0_pm = torch.tensor(np.random.default_rng(44).uniform(0.2, 0.8, dt_pm.shape[0]), **f32)
    times = {}

    f1 = fe.make_cuda_fd_ensemble(f=user_f, f_u=user_f_u, n_steps=s, ref_factor=rf, dt=dt,
                                  device=device)
    stats = {}
    want = fe.fd_ensemble_plain(u0, f1.plan, stats)
    fd_check(f"(b) F1 traced u(1-u)+0.1cos(2t), given f_u, {n} ICs", TRACED[0], f1(u0), want,
             fe.fd_kernel_tolerance(stats, rf), errs, teeth=True, phase="42")
    reg = fe.make_cuda_fd_ensemble("du/dt=sin(u)", s, rf, dt, device=device)
    times[TRACED[0]] = (user_turns(f"(b) F1 {n} ICs", lambda: f1(u0), lambda: reg(u0)),
                        cuda_ms(lambda: fe.fd_ensemble_plain(u0, f1.plan), runs=1))

    f2 = fe.make_cuda_fd_ensemble_vec(f_comps=vdp_comps, jac_comps=vdp_jac, d=2, n_steps=s,
                                      ref_factor=rf, dt=dt, device=device)
    stats = {}
    want = fe.fd_ensemble_vec_plain(u0v, f2.plan, stats)
    fd_check(f"(b) F2 traced Van der Pol d=2, {n} ICs", TRACED[1], f2(u0v), want,
             fe.fd_kernel_tolerance(stats, rf, d=2), errs, teeth=True, phase="42")
    reg_v = fe.make_cuda_fd_ensemble_vec("harmonic_oscillator", s, rf, dt, device=device)
    times[TRACED[1]] = (user_turns(f"(b) F2 {n} ICs (registry: the harmonic oscillator)",
                                   lambda: f2(u0v), lambda: reg_v(u0v)),
                        cuda_ms(lambda: fe.fd_ensemble_vec_plain(u0v, f2.plan), runs=1))
    for d, (name, comps, jac) in USER_VECTOR_D.items():  # up to functor.MAX_VECTOR_D
        fd_ = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=s,
                                           ref_factor=rf, dt=dt, device=device)
        u0d = torch.tensor(np.random.default_rng(40 + d).uniform(-1.5, 1.5, (n, d)), **f32)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0d, fd_.plan, stats)
        fd_check(f"(b) F2 traced {name} d={d}, {n} ICs", TRACED[1], fd_(u0d), want,
                 fe.fd_kernel_tolerance(stats, rf, d=d), errs, teeth=True, phase="42")
        launch = fe.fd_ens_plan(n, s, rf, fe._sm_count(device), d)
        say("42", f"(b) F2 d={d} {n} ICs on {launch}: {cuda_ms(lambda: fd_(u0d), runs=3):.4f} "
                  "ms (median of 3)")

    f3 = fe.make_cuda_fd_estimate_per_member(f=user_f, f_u=user_f_u, n_steps=FD_PM_STEPS,
                                             ref_factor=rf, convention="strided", device=device)
    err_k, j_k = f3(dt_pm, u0_pm)
    stats = {}
    err_p, j_p = fe.fd_estimate_per_member_plain(dt_pm, u0_pm, f3.plan, stats)
    label = f"(b) F3 traced B={u0_pm.shape[0]} {FD_PM_STEPS} steps strided"
    fd_check(label + " err", TRACED[2], err_k, err_p, fe.fd_kernel_tolerance(stats, rf), errs,
             teeth=True, phase="42")
    fd_check(label + " J", TRACED[2], j_k, j_p,
             fe.fd_j_tolerance(stats, FD_PM_STEPS, float(dt_pm.double().sum(1).max())), errs,
             phase="42")
    assert bool((err_k[dt_pm == 0] == 0).all()), "F3 traced: padding must contribute exactly 0"
    reg_pm = fe.make_cuda_fd_estimate_per_member("du/dt=sin(u)", FD_PM_STEPS, rf, "strided",
                                                 device=device)
    times[TRACED[2]] = (user_turns(f"(b) F3 B={u0_pm.shape[0]}", lambda: f3(dt_pm, u0_pm),
                                   lambda: reg_pm(dt_pm, u0_pm)),
                        cuda_ms(lambda: fe.fd_estimate_per_member_plain(dt_pm, u0_pm, f3.plan),
                                runs=1))

    # the registry modes keep their bits (the parent's at these inputs)
    bits = {f"F1 {n}": digest([reg(inp["u0"])]), f"F2 {n}": digest([reg_v(inp["u0_vec"])]),
            f"F3 {dt_pm.shape[0]}": digest(reg_pm(dt_pm, inp["u0_pm"]))}
    say("42", "(b) registry bits: " + ", ".join(
        f"{k} {v} (the parent's {PARENT_DIGESTS.get(k, 'not recorded')})" for k, v in bits.items()))
    for k, v in bits.items():
        assert k not in PARENT_DIGESTS or PARENT_DIGESTS[k] == v, f"{k}: registry bits moved"
    return times, (u0, u0v, u0_pm, f1, f2)


def user_d1(device, errs):
    """Phase 42(c): D1 on the traced f (f_u derived) and g_u = 1/u at
    USER_D1_CASES within dg_kernel_tolerance, some plain |err| above its
    bound, tails exactly 0, timed in turns beside the registry kernel (sin u,
    J = ∫u²); sin(u) as a callable within the registry functor's bounds of
    its output. Returns (ms, plain ms, bound) at bench.py's shape."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch import functionals
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    nqp, nqa = ops_p.phi.shape[0], ops_a.phi.shape[0]
    u2 = functionals.get_functional("J=int(u^2)")
    out = None
    for b, k, newton, seed in USER_D1_CASES:
        times, y0 = user_d1_inputs(device, b, k, seed)
        run = ds.make_cuda_dg_estimate_ensemble(ops_p=ops_p, ops_a=ops_a, f=user_f,
                                                n_elements=k, newton_iters=newton, g_u=user_g_u,
                                                device=device)
        got = run(times, y0)
        want = ds.dg_estimate_ensemble_plain(times, y0, run.plan)
        tol = ds.dg_kernel_tolerance(times, y0, want, run.plan)
        e, share = d1_shares(got, want, tol)
        teeth = int((want[2].abs() > tol["err"]).sum())
        tail = times[:, 1:] == times[:, :-1]
        zero = bool((got[2][tail] == 0).all())
        errs[TRACED[3]] = max(errs[TRACED[3]], *e.values())
        say("42", f"(c) D1 traced u(1-u)+0.1cos(2t) (f_u derived), g_u = 1/u, B={b} K={k} "
                  f"{newton} Newton steps: " + " ".join(
                      f"{x} {e[x]:.3e} (worst {share[x]:.2%} of its bound)" for x in e)
            + f"; {teeth} plain |err| above their bound; {int(tail.sum())} tail slabs exactly 0: "
              f"{zero}")
        assert max(share.values()) <= 1.0, f"B={b}: traced D1 disagrees with its plain version"
        assert teeth > 0 and zero, f"B={b}: the bound has no teeth, or a tail contributed"
        reg = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, newton,
                                                g_u=u2.g_u, device=device)
        ms = user_turns(f"(c) D1 B={b} K={k} (registry: sin u, J = ∫u²)", lambda: run(times, y0),
                        lambda: reg(times, y0))
        if b == USER_D1_CASES[0][0]:
            lam = ds.make_cuda_dg_estimate_ensemble(ops_p=ops_p, ops_a=ops_a, f=user_sin,
                                                    n_elements=k, newton_iters=newton,
                                                    device=device)
            unit = ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops_p, ops_a, k, newton,
                                                     device=device)
            ref = unit(times, y0)
            tol_r = ds.dg_kernel_tolerance(times, y0, ds.dg_estimate_ensemble_plain(
                times, y0, unit.plan), unit.plan)
            e_l, share_l = d1_shares(lam(times, y0), ref, tol_r)
            say("42", f"(c) D1 sin(u) as a callable (Dual<float> f_u) against the registry "
                      f"functor's output, B={b}: " + " ".join(
                          f"{x} {e_l[x]:.3e} (worst {share_l[x]:.2%} of its bound)" for x in e_l))
            assert max(share_l.values()) <= 1.0, "sin(u) traced leaves the registry's bounds"
        else:
            plain_ms = cuda_ms(lambda: ds.dg_estimate_ensemble_plain(times, y0, run.plan), runs=1)
            b_ms = dg_slab_bound(1, k, b, newton, nqp, nqa, per_member=True, goal=True,
                                 pair=sum(functor_ops(user_f, user_f_u)),
                                 gu=sum(functor_ops(user_g_u)))
            out = (ms, plain_ms, b_ms)
    torch.cuda.synchronize()
    return out


def user_h1(device, errs):
    """Phase 42(d): H1 on the traced f and g_u = 1/u at the hp study's
    shape (B = 512, orders 1..3, y0 ~ U(0.2, 0.8)) within
    hp_kernel_tolerance, finite through the padding's zero nodes, tails
    exactly 0, timed in turns beside the registry kernel (sin u, J = ∫u²).
    Returns (ms, plain ms, bound)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch import functionals
    from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
        dg_adjoint_interp_mixed,
        dg_radau_interp_mixed,
    )
    from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

    b, n_user, fo = HP_STUDY["b"], HP_STUDY["n_max"], HP_STUDY["fo"]
    times, ns, _ = hp_inputs(device, b, HP_K, n_user, HP_STUDY["seed"])
    y0 = torch.tensor(np.random.default_rng(45).uniform(0.2, 0.8, b), dtype=torch.float32,
                      device=device)
    mops = dg_time_operators_mixed(n_user + fo)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        mops=mops, interp=dg_adjoint_interp_mixed(mops), f=user_f, n_elements=HP_K,
        n_max_user=n_user, fine_offset=fo, newton_iters=HP_STUDY["newton_iters"],
        rad=dg_radau_interp_mixed(mops), g_u=user_g_u, device=device)
    got = run(times, ns, y0)
    want = hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, want, run.plan)
    e, share = hp_shares(got, want, tol)
    teeth = int((want[3].abs() > tol["err"]).sum())
    tail = times[:, :-1] == HP_STUDY["t1"]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    errs[TRACED[4]] = max(errs[TRACED[4]], *e.values())
    say("42", f"(d) H1 traced f (f_u derived), g_u = 1/u, B={b} K={HP_K} solve: " + " ".join(
        f"{x} {e[x]:.3e} (worst {share[x]:.2%} of its bound)" for x in e)
        + f"; {teeth} plain |err| above their bound; finite through the padding: {finite}; "
          f"{int(tail.sum())} tail slabs exactly 0: {bool((got[3][tail] == 0).all())}")
    assert max(share.values()) <= 1.0, "traced H1 disagrees with its plain version"
    assert teeth > 0 and finite and bool((got[3][tail] == 0).all()), "H1 traced: gates"
    u2 = functionals.get_functional("J=int(u^2)")
    reg = hp_kernel("du/dt=sin(u)", n_user, fo, HP_K, "solve", device, u2.g_u)
    ms = user_turns(f"(d) H1 B={b} (registry: sin u, J = ∫u²)", lambda: run(times, ns, y0),
                    lambda: reg(times, ns, y0))
    plain_ms = cuda_ms(lambda: hm.dg_estimate_hp_per_member_plain(times, ns, y0, run.plan),
                       runs=1)
    b_ms = dg_hp_bound(times, ns, HP_STUDY["newton_iters"], fo, mops.rq.shape[0], mops.np_max,
                       "solve", goal=True, pair=sum(functor_ops(user_f, user_f_u)),
                       gu=sum(functor_ops(user_g_u)))
    return ms, plain_ms, b_ms


def user_paths(device, fd_in):
    """Phase 42(e): each traced kernel through the entry points a user
    calls, its launch count set to 0 just before and read just after: the
    F1 and F2 ensemble signals (one call each at 102,400 ICs), the B = 1024
    per-member FD study on ``ode_f`` (F3), the B = 1024 per-member DG
    study with the device loop on the traced f and g_u = 1/u (D1, its last
    partitions replayed: the kernel gives the history's err bits), and the
    B = 512 hp per-member study on them (H1). Returns the launches."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop, hp_loop
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    u0, u0v, u0_pm, f1, f2 = fd_in
    launches = {}
    fe.reset_launch_counts()
    signal = f1(u0).mean(dim=1)
    launches[TRACED[0]] = fe.fd_ensemble.launches
    fe.reset_launch_counts()
    signal_v = f2(u0v).mean(dim=1)
    launches[TRACED[1]] = fe.fd_ensemble_vec.launches
    assert bool(torch.isfinite(signal).all()) and bool(torch.isfinite(signal_v).all())

    common = dict(tol=0.0, device_loop=True, dtype=torch.float32, device=device, engine="cuda")
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    hist = fd_loop.run_adaptive_fd_per_member(euler_step(user_f), u0_pm.cpu().numpy(),
                                              (0.0, FD_STUDY["t1"]), ode_f=user_f,
                                              maxit=USER_STUDY["maxit"], **common)
    torch.cuda.synchronize()
    launches[TRACED[2]] = fe.fd_estimate_per_member.launches
    wall_fd = time.perf_counter() - t0
    assert all(np.all(np.isfinite(r.err_total)) for r in hist)

    b = USER_D1_CASES[0][0]
    y0s = np.random.default_rng(46).uniform(0.2, 0.8, b).astype(np.float32)
    goal = dict(g=lambda u, t: torch.log(u), g_u=user_g_u, newton_iters=8)
    ds.reset_launch_counts()
    t0 = time.perf_counter()
    hist_dg = dg_loop.run_adaptive_dg_per_member(user_f, y0s, (0.0, DG_SLAB["t1"]), k0=2,
                                                 maxit=USER_STUDY["maxit"], **goal, **common)
    torch.cuda.synchronize()
    launches[TRACED[3]] = ds.dg_estimate_ensemble.launches
    wall_dg = time.perf_counter() - t0
    last = hist_dg[-1]
    k = last.times.shape[1] - 1
    replay = ds.make_cuda_dg_estimate_ensemble(ops_p=dg_time_operators(1),
                                               ops_a=dg_time_operators(2), f=user_f,
                                               n_elements=k, newton_iters=8, g_u=user_g_u,
                                               device=device)
    again = replay(torch.tensor(last.times, dtype=torch.float32, device=device),
                   torch.tensor(y0s, device=device))[2].cpu().numpy()
    same = bool(np.array_equal(again, last.err))
    assert all(np.all(np.isfinite(r.err)) for r in hist_dg) and same

    y_hp = np.random.default_rng(47).uniform(0.2, 0.8, HP_STUDY["b"]).astype(np.float32)
    hm.reset_launch_counts()
    t0 = time.perf_counter()
    hist_hp = hp_loop.run_adaptive_dg_hp_per_member(
        user_f, y_hp, (0.0, HP_STUDY["t1"]), k0=HP_STUDY["k0"], n0=1, n_max=HP_STUDY["n_max"],
        mode="hp", maxit=USER_STUDY["hp_maxit"], **goal, **common)
    torch.cuda.synchronize()
    launches[TRACED[4]] = hm.dg_estimate_hp_per_member.launches
    wall_hp = time.perf_counter() - t0
    assert all(np.all(np.isfinite(r.err)) for r in hist_hp)
    say("42", f"(e) paths: F1 and F2 ensemble signals (max {float(signal.max()):.3e}, "
              f"{float(signal_v.max()):.3e}); run_adaptive_fd_per_member(ode_f=u(1-u)+0.1cos(2t)) "
              f"B={u0_pm.shape[0]} {len(hist)} iterations, wall {wall_fd:.3f} s; "
              f"run_adaptive_dg_per_member(ode=None, f, g_u = 1/u, device loop) B={b} "
              f"{len(hist_dg)} iterations, K [{last.n_active.min()}..{last.n_active.max()}], mean "
              f"|Adj-W Res| {np.abs(hist_dg[0].est_total).mean():.3e} -> "
              f"{np.abs(last.est_total).mean():.3e}, wall {wall_dg:.3f} s, the last partitions' "
              f"err replayed bit for bit: {same}; run_adaptive_dg_hp_per_member B={HP_STUDY['b']} "
              f"{len(hist_hp)} iterations, max order {hist_hp[-1].ns.max()}, wall {wall_hp:.3f} s;"
              f" launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    return launches


def user_refusals(device):
    """Phase 42(f): an untraceable callable raises on every path on the card
    and launches nothing."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop, hp_loop
    from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
    from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe

    def bad(u, t):  # a reduction: no elementwise op
        return torch.sum(u) * u

    y = np.full(8, 0.5, np.float32)
    kw = dict(engine="cuda", maxit=1, dtype=torch.float32, device=device)
    calls = {
        "make_cuda_fd_ensemble": lambda: fe.make_cuda_fd_ensemble(
            f=bad, f_u=user_f_u, n_steps=4, ref_factor=2, dt=0.1, device=device),
        "make_cuda_fd_ensemble_vec": lambda: fe.make_cuda_fd_ensemble_vec(
            f_comps=lambda us, t: (torch.sum(us[0]) * us[1], us[0]), jac_comps=vdp_jac, d=2,
            n_steps=4, ref_factor=2, dt=0.1, device=device),
        "make_cuda_dg_estimate_ensemble": lambda: ds.make_cuda_dg_estimate_ensemble(
            ops_p=dg_time_operators(1), ops_a=dg_time_operators(2), f=user_f, g_u=bad,
            device=device),
        "run_adaptive_fd_per_member": lambda: fd_loop.run_adaptive_fd_per_member(
            euler_step(user_f), y, (0.0, 2.0), ode_f=bad, **kw),
        "run_adaptive_dg_per_member": lambda: dg_loop.run_adaptive_dg_per_member(
            bad, y, (0.0, 2.0), **kw),
        "run_adaptive_dg_hp_per_member": lambda: hp_loop.run_adaptive_dg_hp_per_member(
            user_f, y, (0.0, 2.0), g_u=bad, **kw),
    }
    fe.reset_launch_counts()
    ds.reset_launch_counts()
    hm.reset_launch_counts()
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as exc:
            refused[name] = "cannot trace" in str(exc) and "sum" in str(exc)
        else:
            refused[name] = False
    launched = (fe.fd_ensemble.launches + fe.fd_ensemble_vec.launches
                + fe.fd_estimate_per_member.launches + ds.dg_estimate_ensemble.launches
                + hm.dg_estimate_hp_per_member.launches)
    say("42", f"(f) torch.sum(u)·u on the card: refused with a ValueError naming the op on "
              f"{refused}; kernel launches {launched}")
    assert all(refused.values()) and launched == 0, (refused, launched)


def phase42(device, errs, inp):
    """Traced user functors on F1, F2, F3, D1 and H1: (a) the user
    libraries built together, each its seconds and its instances' registers;
    (b) F1, F2 and F3, (c) D1, (d) H1 at their shapes against their plain
    versions with bounds that bite, timed against the registry kernels;
    (e) each through its path; (f) the refusals. Returns (launches, times,
    bounds) for the kernels line's five traced rows."""
    t0 = time.perf_counter()
    libs, wall = user_libraries()
    names = ("fd_ensemble_kernel", "fd_ensemble_vec_kernel", "fd_estimate_per_member_kernel",
             "dg_estimate_kernel", "hp_kernel")
    for name, lib in libs.items():
        say("42", f"(a) user library {name}: built in {lib.build_seconds:.2f} s "
                  f"({lib.path.name}); " + "; ".join(kernel_registers(lib.build_log, names)))
    say("42", f"(a) {len(libs)} user libraries built together in {wall:.2f} s")
    times, fd_in = user_fd(device, inp, errs)
    ms, plain_ms, b_d1 = user_d1(device, errs)
    times[TRACED[3]] = (ms, plain_ms)
    ms, plain_ms, b_h1 = user_h1(device, errs)
    times[TRACED[4]] = (ms, plain_ms)
    launches = user_paths(device, fd_in)
    user_refusals(device)
    scalar, vdp = functor_ops(user_f, user_f_u), functor_ops((vdp_comps, 2, False),
                                                             (vdp_jac, 2, True))
    f_alone = (functor_ops(user_f)[0], functor_ops((vdp_comps, 2, False))[0])
    fd_b = fd_bounds(pairs=(scalar[0], vdp[0], sum(scalar)), grid_ops=(scalar[1], vdp[1]),
                     f_ops=(f_alone[0], f_alone[1], f_alone[0]))
    bounds = {TRACED[0]: fd_b["fd_ensemble"], TRACED[1]: fd_b["fd_ensemble_vec"],
              TRACED[2]: fd_b["fd_estimate_per_member"], TRACED[3]: b_d1, TRACED[4]: b_h1}
    say("42", f"traced functors: phase wall {time.perf_counter() - t0:.1f} s; bounds "
              + ", ".join(f"{k} {v[0]:.6f} ms ({v[1]})" for k, v in bounds.items()))
    return launches, times, bounds


# --------------------------------------------- high order: Np 9-16 (N = 8-15)

# K1, K2, K2r, KA and B1 against their plain versions at Np 9, 12 and 16 on
# the headline mesh (64 steps: the plain K2 grows with Np); the headline
# pipeline timed at N = 8 and 11
HIGH_CHECK = dict(k=10_000, b=8, n_steps=64, segment=4, orders=(8, 11, 15), b1_lockstep=16)
HIGH_HEADLINE = dict(k=10_000, b=8, n_steps=2048, orders=(8, 11))
HIGH_KERNELS = ("fwd_fused", "rev_fused", "adj_fused", "burgers_fused")
# the kernels' rows at Np 9-16 on the kernels line
HIGH_ROWS = ("fwd_march[Np 9-16]", "adj_est_stored[Np 9-16]", "adj_est_recompute[Np 9-16]",
             "adj_march[Np 9-16]", "burgers_march[Np 9-16]")
# the paths at N = 8 (Np 9): the adaptive study through the driver, the
# decisions where the indicator clears float32 roundoff, Burgers' driver
HIGH_ADAPT_ARGV = ["--adapt", "--kernel", "cuda", "--order", "8", "--k", "16",
                   "--final-time", "0.1", "--maxit", "3"]
HIGH_DECISIONS = dict(n_order=8, k0=6, final_time=0.05, cfl=0.75, maxit=3, tol=1e-12)


def high_inputs(disc, b, device, seed):
    """Phased sines (bench.py's) plus 0.5·U(−1, 1) on every node, whose stiff
    modes lift η above its bound, and the cotangent of J = ∫u with ±50 %
    noise, as (Np, B, K) float32."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent

    rng = np.random.default_rng(seed)
    phases = np.linspace(0.0, 2 * np.pi, b, endpoint=False)
    u0 = np.stack([np.sin(disc.x + p) + 0.5 * rng.uniform(-1, 1, disc.x.shape) for p in phases],
                  axis=1)
    lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
    lam = np.stack([lam * (1 + 0.5 * rng.uniform(-1, 1, lam.shape)) for _ in range(b)], axis=1)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.tensor(u0, **f32), torch.tensor(lam, **f32)


def high_bounds(np_, b, k, n_steps, segment):
    """Least times at Np over n_steps on B·K columns (stage_ops per column
    and stage, recounted for Np): K1 storing the trajectory, K2 on it (as
    dg_bounds), K2r from n_steps/segment checkpoints, KA (advec_bounds)."""
    cols, state = b * k, 4 * np_ * b * k
    geom = 3 * 4 * k
    rc = advec_bounds(np_, cols, n_steps, n_steps // segment)
    return {"K1": k1_bound(np_, b, k, n_steps, n_steps),
            "K2": bound(n_steps * state + 3 * state + geom + 4 * cols,
                        n_steps * (20 * stage_ops(np_) + 3 * np_) * cols),
            "K2r": rc["adj_est_recompute"], "KA": rc["adj_march"]}


def high_check(n_order, device, errs):
    """43(b): K1 (the trajectory), K2 on the kernel's trajectory, K1's
    checkpoints + K2r (K2's bits) and KA against their plain versions on the
    same inputs at HIGH_CHECK's shape and the driver's step 0.75·x_min/a
    (cfl_dt's; at half of it η at Np = 16 lies below its bound), within
    tolerances() (Np/8 above Np = 8) with teeth; B1 in float64
    (1e-12·|plain| + 1e-13) and float32 step by step; then η on smooth data
    (:func:`high_eta_smooth`). Returns ms and plain ms by kernel (CUDA
    events; the kernels median of 3, the plain versions one run)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    c = HIGH_CHECK
    k, b, n, seg = c["k"], c["b"], c["n_steps"], c["segment"]
    disc = mesh(n_order, k, graded=False)
    np_, dt = disc.np_, 2 * cfl_step(disc)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    sms = dg_rhs._sm_count(device)
    plans = (dg_rhs.forward_plan(k, b, np_, n, 1, sms), dg_rhs.stored_plan(k, b, np_, n, sms),
             dg_rhs.recompute_plan(k, b, np_, seg, n, sms), dg_rhs.adjoint_plan(k, b, np_, n, sms))
    assert all(p.threads == 512 for p in plans[1:3]), plans  # K2's registers at Np 9-16
    u0, lam = high_inputs(disc, b, device, seed=n_order)
    out, ms, plain = {}, {}, {}
    ms["K1"] = cuda_ms(lambda: out.update(k1=dg_rhs.fwd_march(u0, 0.0, n, ops, True)), runs=3)
    traj, uf = out.pop("k1")
    ms["K2"] = cuda_ms(lambda: out.update(k2=dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)), 3)
    ckpts, uf_c = dg_rhs.fwd_march_ckpt(u0, 0.0, n, seg, ops)
    ms["K2r"] = cuda_ms(lambda: out.update(
        k2r=dg_rhs.adj_est_recompute(ckpts, lam, 0.0, seg, ops)), runs=3)
    ms["KA"] = cuda_ms(lambda: out.update(ka=dg_rhs.adj_march(lam, n, ops)), runs=3)
    launches = {"K1": dg_rhs.fwd_march.cuda_launches, "K2": dg_rhs.adj_est_stored.cuda_launches,
                "K2r": dg_rhs.adj_est_recompute.cuda_launches,
                "KA": dg_rhs.adj_march.cuda_launches}
    # K1's other modes: the checkpoints and no store (revolve's advance)
    ms["K1 ckpt"] = cuda_ms(lambda: out.update(kc=dg_rhs.fwd_march_ckpt(u0, 0.0, n, seg, ops)), 3)
    launches["K1 ckpt"] = dg_rhs.fwd_march_ckpt.cuda_launches
    ms["K1 no store"] = cuda_ms(lambda: out.update(kn=dg_rhs.fwd_march(u0, 0.0, n, ops)), 3)
    launches["K1 no store"] = dg_rhs.fwd_march.cuda_launches
    plain["K1"] = cuda_ms(lambda: out.update(p1=dg_rhs.fwd_march_plain(u0, 0.0, n, ops, True)),
                          runs=1, warmup=0)
    plain["K2"] = cuda_ms(lambda: out.update(
        p2=dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)), runs=1, warmup=0)
    plain["K2r"] = cuda_ms(lambda: out.update(
        p2r=dg_rhs.adj_est_recompute_plain(ckpts, lam, 0.0, seg, ops)), runs=1, warmup=0)
    plain["KA"] = cuda_ms(lambda: out.update(pa=dg_rhs.adj_march_plain(lam, n, ops)), runs=1,
                          warmup=0)
    plain["K1 ckpt"] = cuda_ms(lambda: dg_rhs.fwd_march_plain(u0, 0.0, n, ops,
                                                              checkpoint_every=seg), 1, 0)
    plain["K1 no store"] = cuda_ms(lambda: dg_rhs.fwd_march_plain(u0, 0.0, n, ops), 1, 0)
    traj_p, uf_p = out["p1"]
    tol = tolerances(n, np_, uf_p, lam)
    pairs = {"K1 traj": (traj, traj_p, "u"), "K1 u_final": (uf, uf_p, "u"),
             "K2 lam0": (out["k2"][0], out["p2"][0], "lam"),
             "K2 eta": (out["k2"][1], out["p2"][1], "eta"),
             "K2r lam0": (out["k2r"][0], out["p2r"][0], "lam"),
             "K2r eta": (out["k2r"][1], out["p2r"][1], "eta"),
             "KA lam0": (out["ka"], out["pa"], "lam")}
    e = {name: float((g - w).abs().max()) for name, (g, w, _) in pairs.items()}
    teeth = {name: int((w.abs() > tol[key]).sum()) for name, (_, w, key) in pairs.items()}
    same = (torch.equal(ckpts, traj[::seg]) and torch.equal(uf_c, uf)
            and torch.equal(out["kc"][0], ckpts) and torch.equal(out["kn"][1], uf)
            and all(torch.equal(a, b_) for a, b_ in zip(out["k2r"], out["k2"])))
    say("43", f"(b) N={n_order} Np={np_} K={k} B={b} steps={n} dt={dt:.4e}: " + ", ".join(
        f"{name} {e[name]:.3e} (tol {tol[key]:.3e}, {teeth[name]} plain entries above)"
        for name, (_, _, key) in pairs.items())
        + f"; K2r = K2, K1's checkpoints and no-store u_final bit for bit: {same}; plans "
        + ", ".join(f"{x} s_f={p.segment} W={p.ghost} L={p.tile} tiles={p.n_tiles}"
                    for x, p in zip(("K1", "K2", "K2r", "KA"), plans)))
    say("43", f"(b) N={n_order} times (ms; kernel median of 3, plain one run): " + ", ".join(
        f"{x} {ms[x]:.3f} ({launches[x]} CUDA launches) plain {plain[x]:.3f}" for x in ms))
    for name, (g, _, key) in pairs.items():
        assert bool(torch.isfinite(g).all()), name
        assert e[name] <= tol[key] and teeth[name] > 0, (name, e[name], tol[key], teeth[name])
    assert same, "K2r leaves K2's bits"
    for row, names in (("fwd_march[Np 9-16]", ("K1 traj", "K1 u_final")),
                       ("adj_est_stored[Np 9-16]", ("K2 lam0", "K2 eta")),
                       ("adj_est_recompute[Np 9-16]", ("K2r lam0", "K2r eta")),
                       ("adj_march[Np 9-16]", ("KA lam0",))):
        errs[row] = max(errs[row], *(e[x] for x in names))
    del traj, traj_p, out
    high_eta_smooth(disc, device, errs)

    # B1 at the same mesh, ΠN, dt = 0.3·x_min
    dt_b = BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
    tab = cb.burgers_tables(disc, dt_b, "n", device)
    plan_b = cb.burgers_plan(k, b, np_, n, "n", False, sms)
    assert plan_b.threads == 512, plan_b  # float32 spills at 1024 threads from Np 11
    label = f"(b) B1 N={n_order} Np={np_} K={k} B={b} dt={dt_b:.4e} ΠN"
    b1_double(label + f" steps={n}", burgers_ics(disc, b, device, torch.float64), n, tab, errs,
              "43", "burgers_march[Np 9-16]")
    u0_b = burgers_ics(disc, b, device, torch.float32)
    b1_lockstep(label, u0_b, c["b1_lockstep"], tab, errs, "43", "burgers_march[Np 9-16]")
    ms["B1"] = cuda_ms(lambda: cb.burgers_march(u0_b, n, tab), runs=3)
    launches["B1"] = cb.burgers_march.cuda_launches
    plain["B1"] = cuda_ms(lambda: cb.burgers_march_plain(u0_b, n, tab), runs=1, warmup=0)
    say("43", f"{label} float32 {n} steps: kernel {ms['B1']:.3f} ms ({launches['B1']} CUDA "
              f"launches; plan s_f={plan_b.segment} W={plan_b.ghost} L={plan_b.tile} tiles="
              f"{plan_b.n_tiles}), plain {plain['B1']:.3f} ms (one run)")
    return ms, plain


def high_eta_smooth(disc, device, errs):
    """43(b): η on the path's own data, bench.py's phased sines and the ∫u
    cotangent at the headline step, where at N ≥ 8 the step-doubling
    residual lies below float32 roundoff and tolerances()' η bound has no
    teeth: K2's η (on K1's trajectory) against the float64 plain run on the
    same trajectory, within 4 times the float32 plain run's own largest
    distance from it; the plain version on the trajectory rounded to
    bfloat16 (a lower-precision control) must land outside."""
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    c = HIGH_CHECK
    b, n = c["b"], c["n_steps"]
    ops = dg_rhs.kernel_ops(disc, A, cfl_step(disc), device)
    u0 = phased_states(disc, b, device, torch.float32)
    lam = batched_cotangent(disc, b, device, torch.float32)
    traj, uf = dg_rhs.fwd_march(u0, 0.0, n, ops, store_trajectory=True)
    eta = dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops)[1].double()
    eta64 = dg_rhs.adj_est_stored_plain(traj.double(), uf.double(), lam.double(), 0.0, ops)[1]
    eta32 = dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)[1].double()
    bf = [x.bfloat16().float() for x in (traj, uf)]
    eta_bf = dg_rhs.adj_est_stored_plain(*bf, lam, 0.0, ops)[1].double()
    del traj, bf
    roundoff = float((eta32 - eta64).abs().max())
    bound = 4 * roundoff
    err, ctrl = float((eta - eta64).abs().max()), float((eta_bf - eta64).abs().max())
    old = tolerances(n, disc.np_, uf, lam)["eta"]
    say("43", f"(b) N={disc.np_ - 1} smooth data (phased sines, headline step, {n} steps): "
              f"max|eta64| {float(eta64.abs().max()):.3e}, float32 plain roundoff "
              f"{roundoff:.3e}; K2's eta {err:.3e} from the float64 run (bound 4x roundoff "
              f"{bound:.3e}, {err / bound:.1%}; tolerances() {old:.3e}); "
              f"bfloat16 trajectory control {ctrl:.3e} ({ctrl / bound:.1f}x the bound)")
    assert err <= bound and ctrl > bound, (err, bound, ctrl)
    errs["adj_est_stored[Np 9-16]"] = max(errs["adj_est_stored[Np 9-16]"], err)


def high_headline(device):
    """43(d): the headline pipeline (K = 10⁴, B = 8, 2048 steps, stored
    trajectory) at N = 8 and 11, and B1 at the same shape (ΠN): ms (CUDA
    events, median of 3 after a warm-up), fwd+adjoint DoF-steps/s, CUDA
    launches, K1 and K2 alone, and the share of their bounds."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

    c = HIGH_HEADLINE
    k, b, n = c["k"], c["b"], c["n_steps"]
    for n_order in c["orders"]:
        disc = mesh(n_order, k, graded=False)
        np_, dt = disc.np_, cfl_step(disc)
        ops = dg_rhs.kernel_ops(disc, A, dt, device)
        u0 = phased_states(disc, b, device, torch.float32)
        lam = batched_cotangent(disc, b, device, torch.float32)
        run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n, b, device,
                                                             store_trajectory=True)
        out = {}
        t_pipe = cuda_ms(lambda: out.update(r=run(u0, 0.0, lam)), runs=3)
        n_cuda = dg_rhs.fwd_march.cuda_launches + dg_rhs.adj_est_stored.cuda_launches
        t_k1 = cuda_ms(lambda: out.update(k1=dg_rhs.fwd_march(u0, 0.0, n, ops, True)), runs=1)
        traj, uf = out.pop("k1")
        t_k2 = cuda_ms(lambda: dg_rhs.adj_est_stored(traj, uf, lam, 0.0, ops), runs=1)
        del traj, uf
        for x in out["r"]:
            assert bool(torch.isfinite(x).all())
        bd = high_bounds(np_, b, k, n, 4)
        b_ms = bd["K1"][0] + bd["K2"][0]
        dof_steps = b * np_ * k * 2 * n
        say("43", f"(d) headline pipeline N={n_order} Np={np_} K={k} B={b} steps={n} "
                  f"dt={dt:.4e}: {t_pipe:.3f} ms (median of 3) = "
                  f"{dof_steps / (t_pipe / 1e3):.4e} fwd+adjoint DoF-steps/s, {n_cuda} CUDA "
                  f"launches; K1 {t_k1:.3f} ms (bound {bd['K1'][0]:.3f} ms, {bd['K1'][1]}, "
                  f"{bd['K1'][0] / t_k1:.3%}), K2 {t_k2:.3f} ms (bound {bd['K2'][0]:.3f} ms, "
                  f"{bd['K2'][1]}, {bd['K2'][0] / t_k2:.3%}); pipeline at {b_ms / t_pipe:.3%} of "
                  f"its bound {b_ms:.3f} ms")
        dt_b = BURGERS["cfl"] * float(np.min(np.abs(disc.x[0] - disc.x[1])))
        tab = cb.burgers_tables(disc, dt_b, "n", device)
        u_b = burgers_ics(disc, b, device, torch.float32)
        t_b = cuda_ms(lambda: out.update(b=cb.burgers_march(u_b, n, tab)), runs=3)
        assert bool(torch.isfinite(out["b"]).all())
        bb = burgers_bound(n_order, k, b, n)
        say("43", f"(d) B1 N={n_order} Np={np_} K={k} B={b} steps={n} ΠN: {t_b:.3f} ms "
                  f"(median of 3) = {b * np_ * k * n / (t_b / 1e3):.4e} DoF-steps/s, "
                  f"{cb.burgers_march.cuda_launches} CUDA launches; bound {bb[0]:.3f} ms "
                  f"({bb[1]}), at {bb[0] / t_b:.3%}")


def high_paths(device, errs):
    """43(e): the paths at N = 8 (Np 9) through the entry points a user
    calls, each with its wrappers' counts set to 0 just before and read just
    after: advec_dg --adapt --kernel cuda --order 8 (K1 + K2) against
    --kernel torch; the same study with no free memory reported (K1's
    checkpoints + K2r), the stored study's history bit for bit; the decisions
    of both engines where the indicator clears float32 roundoff; the march
    alone (K1, no store); make_cuda_advec_adjoint (KA) against its plain
    version; burgers_dg --kernel cuda --order 8 (B1); a tiled call and a
    revolve call against the stored pipeline. Returns the kernels line's
    launches."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.adapt import advec_loop
    from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
    from adjoint_ode_adaptivity_tpu_torch.adjoint.revolve_vjp import revolve_advec_estimate
    from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg, burgers_dg
    from adjoint_ode_adaptivity_tpu_torch.march.advec import cfl_dt
    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs, dg_tiled

    launches = {}
    dg_rhs.reset_launch_counts()
    hist = advec_dg.main(HIGH_ADAPT_ARGV)
    torch.cuda.synchronize()
    launches["fwd_march[Np 9-16]"] = dg_rhs.fwd_march.launches
    launches["adj_est_stored[Np 9-16]"] = dg_rhs.adj_est_stored.launches
    hist_t = advec_dg.main([a if a != "cuda" else "torch" for a in HIGH_ADAPT_ARGV])
    same = [bool(np.array_equal(a.vx, b.vx)) for a, b in zip(hist, hist_t)]
    say("43", f"(e) advec_dg {' '.join(HIGH_ADAPT_ARGV)}: {len(hist)} iterations, K "
              f"{[len(r.vx) - 1 for r in hist]}, steps {[r.n_steps for r in hist]}, wrapper "
              f"launches {launches}; --kernel torch (float32 eager) vertex history equal per "
              f"iteration: {same}; Σeta cuda {[f'{r.est_total:+.3e}' for r in hist]} torch "
              f"{[f'{r.est_total:+.3e}' for r in hist_t]}")
    assert all(v > 0 for v in launches.values()), launches
    eps = 2.0**-23
    for it, r in enumerate(hist):
        j_t, eta_t, disc = eager_estimate(r.vx, r.n_steps, r.dt, device, torch.float32, 8)
        lam = terminal_integral_cotangent(disc, torch.float64, "cpu").numpy()
        tol_j = 8 * np.sqrt(r.n_steps) * eps * float(np.sum(np.abs(lam)))
        tol_eta = 8 * np.sqrt(r.n_steps) * disc.np_ * eps * float(np.max(np.abs(lam)))
        dj, de = abs(r.j_value - j_t), float(np.max(np.abs(r.eta - eta_t)))
        say("43", f"(e) replay it {it} K={disc.k} Np={disc.np_}: |dJ| {dj:.3e} (tol {tol_j:.3e}) "
                  f"max|d eta| {de:.3e} (tol {tol_eta:.3e})")
        assert dj <= tol_j and de <= tol_eta, f"N=8 replay it {it}: cuda vs torch engine"
    _, eta64, _ = eager_estimate(hist[0].vx, hist[0].n_steps, hist[0].dt, device,
                                 torch.float64, 8)
    say("43", f"(e) it 0 float64 eta: max {np.max(np.abs(eta64)):.3e} (the float32 engines' "
              f"decisions at this indicator are roundoff)")

    real = advec_loop._free_device_bytes
    advec_loop._free_device_bytes = lambda device: 0
    try:
        dg_rhs.reset_launch_counts()
        hist_r = advec_dg.main(HIGH_ADAPT_ARGV)
        torch.cuda.synchronize()
        rc = {"fwd_march_ckpt": dg_rhs.fwd_march_ckpt.launches,
              "adj_est_recompute": dg_rhs.adj_est_recompute.launches,
              "adj_est_stored": dg_rhs.adj_est_stored.launches}
    finally:
        advec_loop._free_device_bytes = real
    bits = all(np.array_equal(a.vx, b.vx) and np.array_equal(a.eta, b.eta)
               and a.j_value == b.j_value for a, b in zip(hist, hist_r))
    say("43", f"(e) the same study on the recompute pipeline (no free memory reported): "
              f"wrapper launches {rc}; the stored study's history bit for bit: {bits}")
    assert rc["fwd_march_ckpt"] > 0 and rc["adj_est_recompute"] > 0 and rc["adj_est_stored"] == 0
    assert bits and len(hist_r) == len(hist)
    launches["adj_est_recompute[Np 9-16]"] = rc["adj_est_recompute"]

    kw = dict(HIGH_DECISIONS, device=device)
    hc = advec_loop.run_adaptive_advec(lambda x: np.sin(20 * x), engine="cuda", **kw)
    ht = advec_loop.run_adaptive_advec(lambda x: np.sin(20 * x), engine="torch",
                                       dtype=torch.float32, **kw)
    assert len(hc) == len(ht)
    for a, b in zip(hc, ht):
        np.testing.assert_array_equal(a.vx, b.vx)
    say("43", f"(e) sin(20x) N=8 K0=6 cfl 0.75: cuda and torch vertex histories equal over "
              f"{len(hc)} iterations (K -> {len(hc[-1].vx) - 1}), max|eta| "
              f"{max(float(np.max(np.abs(r.eta))) for r in hc):.3e}, max|d eta| "
              f"{max(float(np.max(np.abs(a.eta - b.eta))) for a, b in zip(hc, ht)):.3e}")

    dg_rhs.reset_launch_counts()
    err = advec_dg.main(["--kernel", "cuda", "--order", "8", "--k", "16"])
    march = {"fwd_march": dg_rhs.fwd_march.launches,
             "adj_est_stored": dg_rhs.adj_est_stored.launches}
    # the same march timed (K1 at B = 1, no store: the TPU's _forward_kernel)
    disc = startup_1d(8, 0.0, 2 * np.pi, 16)
    dt, n_m = cfl_dt(disc, A, 0.75, 2.0)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u_m = torch.tensor(np.sin(disc.x)[:, None, :], dtype=torch.float32, device=device)
    m_ms = cuda_ms(lambda: dg_rhs.fwd_march(u_m, 0.0, n_m, ops), runs=3)
    m_cuda = dg_rhs.fwd_march.cuda_launches
    m_plain = cuda_ms(lambda: dg_rhs.fwd_march_plain(u_m, 0.0, n_m, ops), runs=1, warmup=0)
    m_bound = march_bound(8, 16, n_m)
    say("43", f"(e) advec_dg --kernel cuda --order 8 --k 16 (march only): max error {err:.3e}, "
              f"wrapper launches {march}; the march (K=16, B=1, {n_m} steps) {m_ms:.3f} ms "
              f"({m_cuda} CUDA launches, median of 3), plain {m_plain:.3f} ms (one run), bound "
              f"{m_bound[0]:.6f} ms ({m_bound[1]})")
    assert np.isfinite(err) and err < 1e-4 and march == {"fwd_march": 1, "adj_est_stored": 0}

    disc = startup_1d(8, 0.0, 2 * np.pi, 256)
    dt = cfl_step(disc)
    lam = torch.tensor(np.random.default_rng(43).standard_normal(disc.x.shape),
                       dtype=torch.float32, device=device)
    dg_rhs.reset_launch_counts()
    lam0 = dg_rhs.make_cuda_advec_adjoint(disc, A, dt, 64, device)(lam, 4)
    torch.cuda.synchronize()
    launches["adj_march[Np 9-16]"] = dg_rhs.adj_march.launches
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    want = dg_rhs.adj_march_plain(lam[:, None, :], 256, ops)[:, 0]
    e = float((lam0 - want).abs().max())
    tol = tolerances(256, disc.np_, want, lam)["lam"]
    say("43", f"(e) make_cuda_advec_adjoint N=8 K=256 B=1 256 steps: max|kernel - plain| {e:.3e} "
              f"(tol {tol:.3e}), wrapper launches {launches['adj_march[Np 9-16]']}")
    assert e <= tol and launches["adj_march[Np 9-16]"] == 1
    errs["adj_march[Np 9-16]"] = max(errs["adj_march[Np 9-16]"], e)

    cb.reset_launch_counts()
    u = burgers_dg.main(["--kernel", "cuda", "--order", "8"])
    torch.cuda.synchronize()
    launches["burgers_march[Np 9-16]"] = cb.burgers_march.launches
    d = startup_1d(8, 0.0, 2 * np.pi, 48)
    u0 = torch.tensor(0.5 + np.sin(d.x), dtype=torch.float32, device=device)
    burgers_props(f"(e) burgers_dg --kernel cuda --order 8 (K=48, T=1.5, 7,500 steps, float32; "
                  f"{cb.burgers_march.cuda_launches} CUDA launches)", u, u0, d, 7500, EPS32, "43")
    assert launches["burgers_march[Np 9-16]"] == 1

    disc = startup_1d(8, 0.0, 2 * np.pi, 2048)
    dt = cfl_step(disc)
    u0 = torch.tensor(np.sin(disc.x), dtype=torch.float32, device=device)
    lam = terminal_integral_cotangent(disc, torch.float32, device)
    single = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, 32, device)
    stored = single(u0, 0.0, lam)
    run_tl = dg_tiled.make_cuda_fwd_adj_estimate_tiled(disc, A, dt, segment=4, n_segments=8,
                                                       chunks=4, device=device)
    dg_tiled.reset_launch_counts()
    tiled = run_tl(u0, 0.0, lam)
    tl = {"tiled_fwd_seg": dg_tiled.tiled_fwd_seg.launches,
          "tiled_rev_seg": dg_tiled.tiled_rev_seg.launches}
    same = [torch.equal(a, b) for a, b in zip(tiled, stored)]
    tl_ms = cuda_ms(lambda: run_tl(u0, 0.0, lam), runs=3)
    st_ms = cuda_ms(lambda: single(u0, 0.0, lam), runs=3)
    ops = dg_rhs.kernel_ops(disc, A, dt, device)
    u_b, lam_b = u0[:, None, :].contiguous(), lam[:, None, :].contiguous()

    def plain_pipeline():
        traj, uf = dg_rhs.fwd_march_plain(u_b, 0.0, 32, ops, True)
        dg_rhs.adj_est_stored_plain(traj, uf, lam_b, 0.0, ops)

    pl_ms = cuda_ms(plain_pipeline, runs=1, warmup=0)
    tb = advec_bounds(disc.np_, disc.k, 32)
    say("43", f"(e) make_cuda_fwd_adj_estimate_tiled N=8 K=2048 segment 4 x 8 chunks 4 "
              f"(KT1 + KT2): the stored pipeline's bits {same}, wrapper launches {tl}; "
              f"{tl_ms:.3f} ms against the stored pipeline's {st_ms:.3f} (median of 3), plain "
              f"{pl_ms:.3f} ms (one run); bounds KT1 {tb['tiled_fwd_seg'][0]:.6f} ms "
              f"({tb['tiled_fwd_seg'][1]}), KT2 {tb['tiled_rev_seg'][0]:.6f} ms "
              f"({tb['tiled_rev_seg'][1]})")
    assert all(same) and all(v > 0 for v in tl.values())

    rev = revolve_advec_estimate(disc, A, dt, 512, 64, 4, device=device)
    dg_rhs.reset_launch_counts()
    got = rev(u0, 0.0, lam)
    torch.cuda.synchronize()
    st = rev.revolve_stats
    rl = {"fwd_march": dg_rhs.fwd_march.launches, "adj_est_stored": dg_rhs.adj_est_stored.launches}
    want = dg_rhs.make_cuda_fwd_adj_estimate_single(disc, A, dt, 512, device)(u0, 0.0, lam)
    tol = tolerances(512, disc.np_, want[0], lam)
    e = [float((g - w).abs().max()) for g, w in zip(got, want)]
    eta_above = int(((got[2] - want[2]).abs() > 1e-4 * want[2].abs() + 1e-9).sum())
    say("43", f"(e) revolve_advec_estimate N=8 K=2048 512 steps unit 64 snaps 4: stats {st}; "
              f"wrapper launches {rl}; against the stored pipeline u_final {e[0]:.3e} (tol "
              f"{tol['u']:.3e}) "
              f"lam0 {e[1]:.3e} (tol {tol['lam']:.3e}) eta {e[2]:.3e} ({eta_above} entries "
              f"above 1e-4·|eta| + 1e-9)")
    assert e[0] <= tol["u"] and e[1] <= tol["lam"] and eta_above == 0
    assert rl == {"fwd_march": st["forward_units"] + st["n_units"],
                  "adj_est_stored": st["n_units"]}, rl
    return launches


def phase43(device, lib, errs):
    """High order, Np 9-16: (a) the registers and spills of every instance
    at Np 9-16; (b) K1, K2, K2r, KA and B1 against their plain versions at
    Np 9, 12 and 16; (c) the kernels at Np 2-8 against the parent's digests;
    (d) the headline pipeline and B1 at N = 8 and 11, timed; (e) the paths
    at N = 8. Returns (launches, times, bounds) for the kernels line's
    Np 9-16 rows (times and bounds at 43(b)'s N = 8 shape)."""
    import re

    t0 = time.perf_counter()
    high = [x for x in kernel_registers(lib.build_log, HIGH_KERNELS)
            if int(re.findall(r"\d+", x.split("<", 1)[1])[0]) >= 9]
    say("43", "(a) " + "; ".join(high))
    times = {}
    for n_order in HIGH_CHECK["orders"]:
        ms, plain = high_check(n_order, device, errs)
        if n_order == HIGH_CHECK["orders"][0]:
            for row, x in zip(HIGH_ROWS, ("K1", "K2", "K2r", "KA", "B1")):
                times[row] = (ms[x], plain[x])
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_dg_digests

    got = torch_dg_digests.digests(device)
    bad = {key: (v, PARENT_DIGESTS.get(key)) for key, v in got.items()
           if PARENT_DIGESTS.get(key) != v}
    say("43", f"(c) the kernels at Np 2-8 against the parent's digests "
              f"(tools/torch_dg_digests.py): {len(got) - len(bad)} of {len(got)} equal; "
              f"differing {bad}")
    assert not bad, bad
    high_headline(device)
    launches = high_paths(device, errs)
    c = HIGH_CHECK
    np_ = c["orders"][0] + 1
    bd = high_bounds(np_, c["b"], c["k"], c["n_steps"], c["segment"])
    bounds = {"fwd_march[Np 9-16]": bd["K1"], "adj_est_stored[Np 9-16]": bd["K2"],
              "adj_est_recompute[Np 9-16]": bd["K2r"], "adj_march[Np 9-16]": bd["KA"],
              "burgers_march[Np 9-16]": burgers_bound(c["orders"][0], c["k"], c["b"],
                                                      c["n_steps"])}
    say("43", f"high order: phase wall {time.perf_counter() - t0:.1f} s; launches {launches}; "
              "bounds at N=8 " + ", ".join(f"{k} {v[0]:.6f} ms ({v[1]})"
                                          for k, v in bounds.items()))
    return launches, times, bounds


# ------------------------------------- F2 at d 5-15: the window design (phase 44)

# F2's cases at FD_ENSEMBLE's 102,400 ICs: (label, system, d, steps, rf, dt);
# the window design's at JAX's admitted step counts (fd_ensemble.py:326-334)
WIDE_CASES = (("Lorenz-96 F=8 d=5", "lorenz96", 5, 16, 4, 0.0125),
              ("Lorenz-96 F=8 d=8", "lorenz96", 8, 8, 4, 0.0125),
              ("dense d=15", "dense", 15, 1, 16, 0.1))
WIDE_SEED = 44
L96_FORCING = 8.0
# the dense system's fixed table: A[m][i] = 0.4·sin(1.3m + 0.7i + 0.3) − δ_mi,
# rounded to 4 decimals (every entry nonzero, eigenvalues' real parts < −0.18)
DENSE_A = tuple(tuple(round(0.4 * math.sin(1.3 * m + 0.7 * i + 0.3) - (m == i), 4)
                      for i in range(15)) for m in range(15))


def lorenz96(d, forcing=L96_FORCING):
    """Lorenz-96, u_i' = (u_{i+1} − u_{i−2})·u_{i−1} − u_i + F (indices mod
    d), as (f_comps, jac_comps): its Jacobian has 4 live entries a row, the
    rest literal zeros (skipped). Plain arithmetic: the same callables trace
    into F2's functor and run on JAX's arrays."""

    def f_comps(us, t):
        return tuple((us[(i + 1) % d] - us[(i - 2) % d]) * us[(i - 1) % d] - us[i] + forcing
                     for i in range(d))

    def jac_comps(us, t):
        rows = []
        for i in range(d):
            row = [0.0] * d
            row[(i + 1) % d] = us[(i - 1) % d]
            row[(i - 2) % d] = -us[(i - 1) % d]
            row[(i - 1) % d] = us[(i + 1) % d] - us[(i - 2) % d]
            row[i] = -1.0
            rows.append(tuple(row))
        return tuple(rows)

    return f_comps, jac_comps


def dense_system(d=15, xp=None):
    """u'_m = Σ_i A[m][i]·u_i + 0.1·sin(u_m) with A = DENSE_A's leading
    d×d block, as (f_comps, jac_comps): every Jacobian entry live (the
    off-diagonal ones constants). ``xp`` the array module of sin and cos
    (torch; jax.numpy for JAX's kernel)."""
    if xp is None:
        import torch as xp
    a = [row[:d] for row in DENSE_A[:d]]

    def f_comps(us, t):
        return tuple(sum((a[m][i] * us[i] for i in range(1, d)), a[m][0] * us[0])
                     + 0.1 * xp.sin(us[m]) for m in range(d))

    def jac_comps(us, t):
        return tuple(tuple(a[m][i] + 0.1 * xp.cos(us[m]) if i == m else a[m][i]
                           for i in range(d)) for m in range(d))

    return f_comps, jac_comps


def wide_system(name, d):
    return lorenz96(d) if name == "lorenz96" else dense_system(d)


def jax_admitted_steps(d):
    """The most steps make_pallas_fd_ensemble_vec's scoped-VMEM check
    (fd_ensemble.py:326-334) admits at d: ((s + 1)·d + s + 8·d)·8·2560·4
    bytes within 12 MiB (0: none, d >= 16)."""
    s = 0
    while ((s + 2) * d + s + 1 + 8 * d) * 8 * 2560 * 4 <= 12 * 2**20:
        s += 1
    return s



def wide_u0(name, n, d, seed=WIDE_SEED):
    """Initial states from ``default_rng(seed)``: Lorenz-96's F + 0.5·U(−1, 1),
    the dense system's U(−1, 1), as (n, d) float64 numpy."""
    import numpy as np

    r = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, d))
    return L96_FORCING + 0.5 * r if name == "lorenz96" else r


def wide_bound(n, d, nnz, steps, rf, pair, grid_ops, f_ops):
    """Least time of F2 on n ICs of d components (nnz live Jacobian
    entries), ``steps`` steps refined rf times: bytes (u0 and the grid read
    once, err written once) over 3.35 TB/s against FP32 operations over 67
    TFLOP/s (an FMA 2, a transcendental 1). An IC's coarse step costs f and
    2d; a fine node the interpolation (3 a component off a coarse node),
    the pair, r (3d), A (2d), h·J (nnz), the v update (d + 2·nnz) and r·v
    (2d); a block's |sum| 1. ``pair`` and ``f_ops`` are the functors'
    operations on the state (functor_ops), ``grid_ops`` those on t alone,
    once a fine node of the shared grid."""
    node = d * (3 * (rf - 1) / rf + 3 + 2 + 1 + 2) + 3 * nnz + pair
    n_bytes = 4 * n * d + 4 * steps * n + 4 * (2 * steps + 2 * steps * rf + rf)
    n_ops = n * ((f_ops + 2 * d) * steps + steps * rf * node + steps) + steps * rf * grid_ops
    return bound(n_bytes, n_ops)


def wide_libraries():
    """Phase 44's user libraries (one a case), built together. Returns
    {label: (KernelFunctors, KernelLibrary)} and the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import vector_functors

    kfs = {}
    for label, name, d, *_ in WIDE_CASES:
        comps, jac = wide_system(name, d)
        kfs[label] = vector_functors(f_comps=comps, jac_comps=jac, d=d, source="fd_ensemble.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kfs)) as pool:
        libs = dict(zip(kfs, pool.map(lambda kf: kf.library(), kfs.values())))
    return {k: (kfs[k], libs[k]) for k in kfs}, time.perf_counter() - t0


def phase44(device, errs):
    """F2 at d 5-15 on traced callables, 102,400 ICs: per case of
    WIDE_CASES (a) the user library's build seconds and the registers and
    spills of the instance the plan runs; the kernel against its plain
    version within fd_kernel_tolerance(…, d), some plain entry above it,
    and a bfloat16 run of the plain version outside it (the control); the
    device ms (20 calls queued behind a sleep, median of 5), the ms through
    the call (median of 5), the plain ms and the bound; the other design on
    the same inputs where it takes them (Lorenz-96: the window design, its
    bits beside the register design's); (b) each case through the entry
    point, its launch count set to 0 just before and read just after; (c)
    the registry F2 and the traced d = 2, 3 and 4 against the parent's
    digests (tools/torch_fd_digests.py) (every d of 2-15 at every step count
    JAX admits: tests/test_torch_cuda.py).
    Returns (launches, (ms, plain ms),
    bound) for the kernels line's row at case (c)."""
    import numpy as np
    import torch

    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import functor

    t0 = time.perf_counter()
    key = "fd_ensemble_vec[d 5-15]"
    n = FD_ENSEMBLE["n_ics"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    libs, wall = wide_libraries()
    say("44", f"(a) {len(libs)} user libraries built together in {wall:.2f} s")
    runs, row = {}, None
    for label, name, d, steps, rf, dt in WIDE_CASES:
        kf, lib = libs[label]
        comps, jac = wide_system(name, d)
        run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=steps,
                                           ref_factor=rf, dt=dt, device=device)
        u0 = torch.tensor(wide_u0(name, n, d), dtype=torch.float32, device=device)
        launch = fe.f2_plan(n, steps, rf, sms, d, kf.nnz)
        window = isinstance(launch, fe.FdVecLaunch)
        inst = "fd_ensemble_vec_window_kernel" if window else "fd_ensemble_vec_kernel"
        regs = [r for r in kernel_registers(lib.build_log, (inst,)) if r.startswith(inst + ":")]
        say("44", f"(a) {label}, {steps} steps rf {rf} dt {dt}, {kf.nnz} live Jacobian entries: "
                  f"built in {lib.build_seconds:.2f} s; plan {launch} "
                  f"({'window' if window else 'register'} design); {'; '.join(regs)}")
        got = run(u0)
        stats = {}
        want = fe.fd_ensemble_vec_plain(u0, run.plan, stats)
        tol = fe.fd_kernel_tolerance(stats, rf, d)
        fd_check(f"(a) {label}", key, got, want, tol, errs, teeth=True, phase="44")
        errs["fd_ensemble_vec"] = max(errs["fd_ensemble_vec"], errs[key])
        control = fe.fd_ensemble_vec_plain(u0.to(torch.bfloat16), run.plan)
        e_ctl = float((control.double() - want.double()).abs().max())
        say("44", f"(a) {label}: the plain version in bfloat16 {e_ctl:.3e} from the float32 "
                  f"one, {e_ctl / tol:.1f}x the tolerance (the control lies outside it)")
        assert e_ctl > tol, f"{label}: a bfloat16 run passes the tolerance"
        dev = statistics.median(queued_ms(lambda: run(u0)) for _ in range(5))
        call = cuda_ms(lambda: run(u0), runs=5)
        plain_ms = cuda_ms(lambda: fe.fd_ensemble_vec_plain(u0, run.plan), runs=1)
        pair, on_t = functor_ops((comps, d, False), (jac, d, True))
        b_ms, b_by = wide_bound(n, d, kf.nnz, steps, rf, pair, on_t,
                                functor_ops((comps, d, False))[0])
        say("44", f"(a) {label}: {dev:.4f} ms on the device (20 calls queued behind a sleep, "
                  f"median of 5), {call:.4f} ms a call (median of 5), plain {plain_ms:.3f} ms; "
                  f"bound {b_ms:.6f} ms ({b_by}), {b_ms / dev:.2%} of it")
        if not window:
            other = fe.vec_window_plan(steps, rf, d, kf.nnz)
            got_w = fe._f2_launch(u0, run.plan, other)
            dev_w = statistics.median(
                queued_ms(lambda: fe._f2_launch(u0, run.plan, other)) for _ in range(5))
            fd_check(f"(a) {label} on the window design {other}", key, got_w, want, tol, errs,
                     phase="44")
            say("44", f"(a) {label} on the window design: {dev_w:.4f} ms on the device against "
                      f"the register design's {dev:.4f}; the register design's bits: "
                      f"{bool(torch.equal(got_w, got))}")
        runs[label] = (run, u0)
        row = ((dev, plain_ms), (b_ms, b_by))
    launches = 0
    for label, (run, u0) in runs.items():
        fe.reset_launch_counts()
        signal = run(u0).mean(dim=1)
        torch.cuda.synchronize()
        count = fe.fd_ensemble_vec.launches
        say("44", f"(b) {label} through make_cuda_fd_ensemble_vec: {count} CUDA launch; signal "
                  f"finite {bool(torch.isfinite(signal).all())}, shape {tuple(signal.shape)}")
        assert count == 1 and bool(torch.isfinite(signal).all()), label
        launches += count
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_fd_digests

    got = {k: v for k, v in torch_fd_digests.digests(device).items() if k.startswith("F2")}
    bad = {k: (v, PARENT_DIGESTS.get(k)) for k, v in got.items() if PARENT_DIGESTS.get(k) != v}
    say("44", f"(c) F2 at d = 2-4 against the parent's digests (tools/torch_fd_digests.py): "
              f"{len(got) - len(bad)} of {len(got)} equal; differing {bad}")
    assert not bad, bad
    assert functor.MAX_VECTOR_D == 15
    say("44", f"F2 at d 5-15: phase wall {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches, row[0], row[1]


def instance_name(mangled: str) -> str:
    """A kernel instance's readable name from its mangled one, e.g.
    dg_estimate_kernel<4, OdeSin<Libm>>."""
    import re

    m = re.search(r"([a-z_]+_kernel)I(?:Li(\d+)E)?N3aoa(\d+)", mangled)
    if m is None:
        return mangled
    ode = mangled[m.end(): m.end() + int(m.group(3))]
    trig = next((t for t in ("FastTrig", "Libm") if t in mangled), None)
    args = ([m.group(2)] if m.group(2) else []) + [f"{ode}<{trig}>" if trig else ode]
    return f"{m.group(1)}<{', '.join(args)}>"


def main() -> int:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"nvidia-smi failed: {exc}", file=sys.stderr)
        return 1
    print(smi.splitlines()[0], flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / PACKAGE).is_dir():
        print(f"{PACKAGE}/ not found beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    device = torch.device("cuda")
    say("0", f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; TF32 off")

    import numpy as np

    from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library

    join64 = burgers_eager64()
    t0 = time.perf_counter()
    lib = load_library()
    build_s = time.perf_counter() - t0
    march64 = join64()
    log = lib.build_log.splitlines()
    regs = [ln.split()[4] for ln in log if "registers" in ln]
    spills, name = [], ""
    for ln in log:
        if "Function properties for" in ln:
            name = ln.split(" for ", 1)[1].strip()
        elif "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{instance_name(name)} ({ln.strip()})")
    say("1", f"kernels built in {build_s:.2f} s ({lib.path.name}), phase 20's float64 eager "
             f"march beside them joined at {time.perf_counter() - t0:.2f} s; "
             f"{len(regs)} kernel instances, registers {sorted(set(regs), key=int)}, "
             f"spilling instances {len(spills)}: {spills}")

    errs = {name: 0.0 for name in TPU_KERNELS}
    compare_case("(a) graded", mesh(2, 24, graded=True), 8, 64, device, errs)
    compare_case("(b) N=7", mesh(7, 24, graded=False), 8, 64, device, errs)
    compare_case("(c) headline shapes", mesh(2, 10_000, graded=False), 8, 64, device, errs)

    launches, last_vx = phase3(device)
    compare_case("(d) adaptive study's last mesh",
                 startup_1d(2, 0.0, 2 * np.pi, len(last_vx) - 1, vx=last_vx), 1, 64, device, errs)
    times = phase4(device, errs)
    march_times(device, errs)
    phase5(device)

    inp = fd_inputs(device)
    phase6(device, errs, inp)
    launches.update(phase7(device, errs, inp))
    times.update(fd_times(device, inp))
    study_times(device)

    cases = phase9(device, errs)
    launches.update(phase10(device, errs))
    times["dg_estimate_ensemble"] = dg_times(device, cases)

    hp_cases = phase12(device, errs)
    launches.update(phase13(device, errs))
    hp_ms, hp_plain_ms, hp_bound = hp_times(device, hp_cases)
    times["dg_estimate_hp_per_member"] = (hp_ms, hp_plain_ms)

    t1_in = phase15(device, errs)
    phase16(device, errs)
    launches.update(phase17(device, errs))
    nn = nn_times(device, t1_in)
    for name, (ms, plain_ms, _) in nn.items():
        times[name] = (ms, plain_ms)

    plain_b1, bench_b1 = phase19(device, errs)
    launches["burgers_march"], _ = phase20(device, errs, march64)
    rev = phase21(device, errs)
    b1_ms, b1_bound = burgers_times(device, plain_b1, bench_b1)
    times["burgers_march"] = (b1_ms, plain_b1)

    rc_launches, rc_times, rc_bounds = phase23(device, errs)
    tl_launches, tl_times, tl_bounds = phase24(device, errs)
    phase25(device, rev["beyond"])
    phase26(device, errs)
    km_launches, km_times, km_bounds = phase27(device, errs)
    phase28(device)
    phase29(device, lib)
    phase30(device, lib)
    phase31(device, lib)
    phase32(device, lib, errs)
    phase33(device, lib, errs)
    phase34(device, lib, errs, hp_cases)
    phase35(device, lib, errs, cases)
    phase36(device, lib, errs, inp)
    phase37(device, lib, errs, inp)
    md_launches, md_times, md_bounds = phase38(device, lib, errs)
    phase39(device, lib, errs, inp)
    phase40(device, errs)
    phase41(device)
    us_launches, us_times, us_bounds = phase42(device, errs, inp)
    hi_launches, hi_times, hi_bounds = phase43(device, lib, errs)
    wide = "fd_ensemble_vec[d 5-15]"
    launches[wide], times[wide], wide_b = phase44(device, errs)
    launches.update(rc_launches, **tl_launches, **km_launches, **md_launches, **us_launches,
                    **hi_launches)
    times.update(rc_times, **tl_times, **km_times, **md_times, **us_times, **hi_times)
    bounds = {**dg_bounds(), **fd_bounds(), "dg_estimate_hp_per_member": hp_bound,
              **{name: v[2][:2] for name, v in nn.items()}, "burgers_march": b1_bound,
              **rc_bounds, **tl_bounds, **km_bounds, **md_bounds, **us_bounds, **hi_bounds,
              wide: wide_b}
    # no single PyTorch call computes any of these pipelines: library_ms is null
    # (T2's hidden-chain GEMMs through torch.matmul are printed in phase 18 as
    # a yardstick; they are not the same function)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in TPU_KERNELS
    ]
    ends = sorted(SAID.items(), key=lambda kv: kv[1][1])
    print("[walls] seconds from the line before each phase's first to its last: "
          + ", ".join(f"{p} {t1 - (ends[i - 1][1][1] if i else first):.1f}"
                      for i, (p, (first, t1)) in enumerate(ends)), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
