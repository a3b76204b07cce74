#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (osqp_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build of every kernel from the sources in the checkout (nvcc, sm_90a),
   one nvcc per source, all started together, and of the LDL' symbolic
   pass (g++);
3. K1 (shared_epoch) against its plain PyTorch version on the card, one epoch
   from the same state, at the batched path's shapes: B=4096, n=32, m=48
   (the batched condensed-MPC headline) in f32 and f64, f32 at B=1024,
   n=128, m=192, and f64 at a ragged B=333, n=13, m=19; then its reduced
   iteration precisions, iter_prec 'high' and 'default' (the tensor-core
   product), in f32 at the headline, at n=128, m=192 and at the ragged
   shape, each at K=1 and K=25 (every mode's statuses, objectives and dual
   objectives bit for bit those of the plain check on the kernel's own
   iterates); with each launch's plan and the design it
   picks (the register-resident wgmma design, or the streamed mma.sync one
   at n=128, m=192), the columns it iterates, and the kernel's (device time
   at K=25 and K=0, one iteration's time between them, and CUDA events over
   back-to-back launches), the plain version's and the unfused torch
   epoch's (in the same mode) device times; each K1 instantiation's
   registers and spills from the ptxas report (the wgmma design must not
   spill), and each reduced mode's time over 'highest''s at the headline;
4. the batched main path end to end: BatchedOSQP setup, cold solve, then a
   10-step warm MPC rollout (update(q) with q + 0.01 noise, then solve) at
   the headline shape in f32, eps 1e-3.  Every instance must be solved, every
   returned solution must pass its termination test recomputed on the host in
   float64, 64 instances must lie near the port's own float64 CPU optimum at
   every step, and K1 must have launched; then its profile.  Then the same
   rollout with iter_prec='high' (every instance solved, the float64 host
   check, K1 launched, and its profile), and one cold solve with
   iter_prec='default' and max_iter 500, held to the safety contract (only
   solved, solved-inaccurate or max-iter outcomes, and every solved
   instance passes its host check);
4b. the vmap engine (BatchedOSQP with a P and an A per instance: the
   condensed-MPC family with a plant per instance, from numpy with seed 0)
   at the headline shape, eps 1e-3: float32 (kkt_method 'inv') and float64
   ('chol'), each setup, a cold solve and 10 warm update(q) steps; then
   B=1024, n=128, m=192 in float32 (cold and 3 warm) and one cold float64
   solve with the indirect solver (PCG) at the headline shape.  Every
   instance solved, every returned solution passing its float64 host check,
   64 instances near the port's own float64 CPU optimum (float32 and
   float64 runs); warm solves/s, iterations, rho updates, host syncs, CG
   steps and a profile of one more warm step (idle share, launches per ADMM
   iteration, heaviest kernels);
4c. batch_qp_solve and a 10-step mpc_rollout at the headline shape in
   float32: the pure solve gives BatchedOSQP's statuses and iterations, the
   rollout the step-by-step BatchedOSQP run's, its results stay on the card
   and its device-to-host copies (profiled) are no more than the loop's
   per-epoch syncs;
4d. the differentiable layers at B=256, n=32, m=48, eps 1e-4 (float64):
   nn.torch.OSQP forward and forward+backward on CUDA tensors (solves/s,
   every status solved), its x and five gradients against the same call on
   CPU tensors within 1e-6 of each gradient's max-norm, a profile; then
   five steps of examples/qp_layer.py's loop with make_qp_layer on the
   card, whose loss must fall at every step.  These paths run no
   hand-written kernel (the JAX package computes them with no Pallas
   kernel either);
5. K2 (dia_matvec) against its plain PyTorch version on the card: the sparse
   path's own DIA operators at n = 2^20 (P with 3 bands, A and A' with 2) in
   f32 and f64, gram_diag in f64 with a 0/1 mask / delta weight (as the
   polish calls it), a ragged case (m_out != n_in, more than 64 bands,
   offsets up to +-5000) and the empty case; with the kernel's, the plain version's and
   cuSPARSE's (torch.sparse_csr_tensor @ v) times and the byte bound;
6. the sparse single-QP main path: osqp_tpu_torch.OSQP(sparse=True) in f32 on
   the banded QP family of examples/huge_banded_qp.py at n = 2^20, eps 1e-3:
   setup, a cold solve and 3 warm update(q) steps.  Both operators must be
   DIA, every step solved, every returned solution must pass its termination
   test recomputed on the host in float64 with scipy, and K2 must have
   launched; then the same family at n = 16384 in f64 on the card against
   the CPU, and a profile of one more warm step;
7. polish, time_limit, SIGINT and verbose on the single-QP path: the n = 2^20
   QP again, cold, with the float64 polish (PCG on the masked DIA operator,
   K2 in f64, launches counted around the polish alone; the polished
   solution must pass its f64 host termination test and an accepted polish
   must not raise either residual), then one more under the profiler; the
   polish at n = 16384 in f64 on the card against the CPU (same
   status_polish, PCG steps within 1%, x and y within 1e-9); the dense
   direct path with polish (f64 Cholesky) at n = 2000, m = 3000 (rejected
   at density 0.01, so its line search runs there, accepted at 0.002); a
   rejected polish's line search at n = 30; time_limit = 0.05 s and a real SIGINT
   from a timer started when the first chunk completes, at n = 2^20, each
   stopping after whole chunks; and one
   verbose solve at n = 2^20 whose console rows are printed and counted;
8. three more single-QP paths, each OSQP(sparse=True) in float64 at eps
   1e-3 with the format ladder on auto: setup, a cold solve and two warm
   update(q) steps (the Portfolio path, whose every solve runs to max_iter,
   its cold solve only, cut to 300 iterations and its profile to 50), with
   every kernel's launch count set to 0 just before
   and read just after, then a profile of one more warm step.  The ELL
   family (an even-row random graph QP, n = 2^20: both operators ELL, K3),
   the BSR family (tests/test_spmv.py's clustered QP at nsb = 1024,
   n = 131,072: both BSR, K4) and the Portfolio problem of the OSQP
   benchmark suite (100,000 assets, 1,000 factors: P DIA, K2; A the CSR
   fallback, cuSPARSE).  Formats as expected, the path's kernel launched,
   every step solved and passing its f64 host termination test.  After the
   ELL and BSR paths, K3 and K4 against their plain versions on the path's
   own operators (f64 and f32, with the operator's own per-row counts and
   K3's lanes per row) and on ragged shapes, with error relative to each
   row's sum of |a| |v| (f32 1e-5, f64 1e-12), device ms with the L2 warm
   and cold, the plain version's and cuSPARSE's times, their ratio and the
   bound; K3 on each f64 operator at 4, 8, 16 and 32 lanes per row, one line
   each; and a non-finite v on each path's f64 operators, whose NaN
   positions must equal the plain version's;
9. the three families at a small size on the card against the CPU in f64
   with a polish (same formats and statuses, iterations within 5%, x within
   1e-6 of ||x||), and the derivative API on the card against the CPU on
   tests/test_derivative.py's problems and a dense random QP at n = 2000,
   m = 3000 (within 1e-9 relative);
10. codegen and export: the models of phases 6 and 8 (banded f32 DIA at
   n = 2^20: K2; ELL at n = 2^20 and BSR at n = 131,072, f64: K3, K4) and a
   dense direct f64 model (phase 7's random QP at n = 2000, m = 3000,
   density 0.002, whose cold solve refactors once) are each exported with
   ``codegen.driver.export_aot`` (a torch.export program) right after their
   setup and run once cold, every launch count set to 0 just before the
   exported call and read just after (then restored); each must give the
   live cold solve's status and iterations (and CG steps, sparse), pass
   the f64 host termination test, and launch its path's kernel; the banded
   program goes through torch.export.save and load and must give the same
   outputs bit for bit.  Then OSQP.codegen from card models of
   tests/test_codegen.py's vectors problem and its n = 2000 sparse problem
   (the sparse emitter, eps 1e-7): the emitted workspace.c and
   emosqp_solver.c compiled with the system C compiler into a shared
   library, osqp_solve called through ctypes: solved, x within 1e-4 of the
   live solve's;
11. the multi-device package (osqp_tpu_torch.parallel) on a mesh of 4 shards
   (round robin over the cards: all on cuda:0 on a one-card machine), its
   devices printed: the banded family of phase 6 at n = 2^20 in f64, eps
   1e-3, through banded_qp_setup, a cold banded_qp_solve and a 3-step
   banded_mpc_rollout (phase 6's q * 1.01^k, warm from the cold solve),
   every step solved and passing the f64 host termination test, K2 (the
   local products on each shard's halo window) launched; the same problem
   through big_qp_setup and big_qp_solve (row blocks on cuSPARSE): solved,
   the host test, banded's iteration count and x within 1e-8, and a second
   cold solve that says whether two runs are bit-identical; a profile of
   one warm solve of each; K2 on an interior shard's halo window
   (L = 2^18, on that shard's device) for P, A and A' in f32 and f64, bit
   for bit against its plain version, P's with device times (L2 warm and
   flushed) and the byte bound; banded and bigqp at n = 4096 and
   dp_mp_solve at (2, 2), B = 8, f64, on the card against the CPU (statuses, iterations and rho updates
   equal, x within 1e-9); dp_mp_solve on a (2, 2) mesh at B = 4096, n = 32,
   m = 48 (phase 4b's plant family), f64, eps 1e-3: every instance solved,
   the f64 host check, 64 instances near the port's f64 CPU optimum,
   solves/s.  Wall time, CG steps and host syncs of each solve;
11b. the same paths on a mesh over processes (osqp_tpu_torch.parallel.
   distributed), each process a child of this script (``--mesh-worker``)
   with a wall limit past which it is killed and the run fails: two gloo
   processes sharing cuda:0, two shards each (J = 4; gloo moves the bytes
   of every exchange through pinned host memory), run phase 11's banded
   setup, cold solve and 3-step rollout at n = 2^20 (K2 launched in each
   process, its count printed per process), big_qp_setup and big_qp_solve,
   and dp_mp_solve on (2, 2) with dp across the processes at B = 4096:
   every step and instance solved, the f64 host check, and every process's
   counts, host syncs and x/y phase 11's bit for bit (bigqp: bit for bit
   where two one-process runs are, else within 1e-12 of ||x|| with equal
   counts; the line says which held); then one NCCL process a card (one on
   a one-card machine), two shards each, the banded family at n = 2^16:
   the one-process mesh's counts, the world size printed.  Wall, CG steps,
   host syncs and wall per CG step of each solve beside phase 11's, with
   the card's name and power limit;
12. the 'ldl' algebra (float64 sparse direct solves by an LDL' of the full
   KKT matrix): K5 (ldl_factor, the numeric factorization) and K6
   (ldl_solve, the triangular solves) against their plain versions on the
   KKT matrices of the Portfolio at 2,000 x 20 and of the banded family at
   n = 4,096 (an elimination-tree chain): L and D within 1e-10 of each
   column's max-norm, n_positive equal, the solve within 1e-12 of
   ||b||_inf, two runs of each bit-identical; then each kernel's device ms,
   launches (K5's equal to the symbolic pass's count), bounds, plain ms,
   the supernodes (count, columns, share of nnz(L)), the time of torch's
   sparse-CSR triangular solve and of torch.linalg.ldl_factor on the dense
   KKT matrix (a near relative of K5: it pivots) at the Portfolio 10,000 x
   100 and the banded n = 2^16 KKT matrices; the main path,
   OSQP(algebra='ldl') on the Portfolio at 10,000 x 100 (seed 0, f64, eps
   1e-3): setup (Ruiz, symbolic pass and K5 timed apart), a cold solve and
   two warm update(q) steps, every step solved and passing its f64 host
   termination test, K5 called once per factorization in the launches the
   symbolic pass states and K6 launched, a profile of one more warm step,
   and a polished solve from zero iterates; then the card against the CPU (the
   Portfolio at 2,000 x 20, tests/problems.py's feasibility and
   primal_infeasible: statuses, iterations within 5%, x within 1e-6) and a
   non-convex P raising OSQP_NONCVX_ERROR through K5's inertia;
13. a JSON line with each kernel's numbers (with its launches inside the
   exported programs and on the distributed banded path, in one process and
   in each process of phase 11b), then the result
   line {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  It needs the repository's
``osqp_tpu_torch`` beside it and a CUDA device.

    python3 chip_smoke.py --k1

builds K1, runs only phase 3 and prints no result line.
"""

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of the cards this may run on (NVIDIA data sheets, dense):
# (fp32 FLOP/s on the CUDA cores, fp64 FLOP/s with the tensor cores' DMMA,
# memory bytes/s, bf16 FLOP/s on the tensor cores).  Bounds take the card's
# peak for the type, whatever units the kernel itself uses.
PEAKS = {
    'H100 PCIe': (51.2e12, 51.2e12, 2.0e12, 756e12),
    'H100 NVL': (60e12, 60e12, 3.9e12, 835e12),
    'H100': (67e12, 67e12, 3.35e12, 989e12),  # SXM5
}

HEADLINE = (4096, 32, 48)
EPS = 1e-3
STEPS = 10
K = 25  # iterations per epoch (check_termination)
DEV = 'cuda'


def build_shared_problems(B, n, m, seed=0):
    """Shared P/A, per-instance q/l/u (condensed-MPC scenario batch), the
    problem family of the repository's benchmark."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    P = L @ L.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m)) + 0.1
    u = x0 @ A.T + s0
    l = u - 2 * s0
    return P, q, A, l, u


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f'no peak rates known for {name!r}')


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn, reps, flush=None):
    """Device time of one call of ``fn`` from CUDA events recorded just
    before and after it, the mean over ``reps`` calls after a warm-up.
    Before each call the card spins for about 0.5 ms (``torch.cuda._sleep``,
    which touches no memory, so the L2 stays as it was), while the host
    queues the events and ``fn``'s launches behind it: the events then time
    the device's work alone, not the host's launch gaps.  ``flush`` runs
    before the spin, outside the count (an L2 flush).  Unlike ``device_ms``
    it loses no call to a dropped profiler record."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def device_ms(fn, reps, name=None, flush=None, tries=3):
    """Device time of one call of ``fn``: the summed durations of the device
    kernels and copies it runs (only those whose name holds ``name``, when
    given), over ``reps`` calls under torch.profiler, after a warm-up.  Unlike
    ``cuda_ms`` this leaves out the host's time between launches.  ``flush``
    runs before each call, outside the count (an L2 flush).  With ``name``,
    ``fn`` launches that kernel once, and the time is the mean over the
    launches the profiler recorded: a trace can drop records (1 of 50, 17
    of 20 or 15 of 20 have gone missing), which a sum over ``reps`` would
    read as a shorter kernel.  A profile that recorded fewer than half of
    them, or (without ``name``) no device time at all, is taken again, up to
    ``tries`` times.  Without ``name`` the sum over ``reps`` stands, which a
    dropped record shortens (``event_ms`` does not)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (name is None or name in e.key)]
        total = sum(e.self_device_time_total for e in evs)
        recorded = sum(e.count for e in evs)
        if total > 0 and name is None:
            return total / 1e3 / reps
        if total > 0 and 2 * recorded >= reps:
            return total / 1e3 / recorded
        print(f'device_ms: the profiler recorded {recorded} records of {reps} calls of '
              f'{name or fn}; profiling again', flush=True)
    raise AssertionError(f'the profiler recorded no device time, or fewer than half of {reps} '
                         f'launches, for {name or fn} in each of {tries} profiles')


def epoch_inputs(B, n, m, dtype, seed):
    """The fused epoch's inputs at a state up to three plain epochs from a
    cold start, so that converged and active columns are both present, or,
    where one epoch converges every column, so that the kernel's epoch
    captures many."""
    from osqp_tpu_torch import batch_shared as bs
    from osqp_tpu_torch.ops import shared_epoch as se
    from osqp_tpu_torch.settings import OracleSettings, default_core_settings

    P, q, A, l, u = build_shared_problems(B, n, m, seed=seed)
    host = OracleSettings(eps_abs=EPS, eps_rel=EPS)
    stg = default_core_settings(dtype, eps_abs=EPS, eps_rel=EPS)
    P_s, A_s, Q, L, U, scal, rho0, Minv, M, rvec = bs.shared_setup(
        P, A, q, l, u, host, dtype=dtype, device=DEV)
    rinv = torch.where(rvec > 0, 1.0 / rvec, 0.0)
    F, c0 = bs._build_affine(A_s, A_s.T, Minv, M, rvec, rinv, stg.sigma, stg.alpha, Q)
    fixed = (F, torch.cat([P_s, A_s]), A_s.T.contiguous(), rvec, rinv,
             scal.D, scal.Dinv, scal.E, scal.Einv, c0, Q, L, U)
    sc = se.epoch_scalars(stg, scal.c, scal.cinv, K)
    z = torch.zeros
    state = (z((n + 2 * m, B), dtype=dtype, device=DEV),
             z((n, B), dtype=dtype, device=DEV), z((m, B), dtype=dtype, device=DEV),
             z((n + 2 * m, B), dtype=dtype, device=DEV),
             z((n, B), dtype=dtype, device=DEV), z((m, B), dtype=dtype, device=DEV),
             torch.full((B,), se.UNSOLVED, dtype=torch.int32, device=DEV))
    for _ in range(3):  # stop before an epoch that would leave no column active
        nxt = se.shared_epoch_plain(*fixed, *state, sc)[:7]
        if not bool((nxt[6] == se.UNSOLVED).any()):
            break
        state = nxt
    ctx = dict(P=P_s, A=A_s, Q=Q, L=L, U=U, scal=scal, stg=stg)
    return fixed, state, sc, ctx


def unfused_epoch(fixed, state, sc, ctx):
    """The JAX package's unfused epoch in torch ops (iterations, merge,
    batch termination check, capture): the yardstick the fused kernel
    replaces.  The port runs it only with fused=False."""
    from osqp_tpu_torch import batch_shared as bs
    from osqp_tpu_torch.ops import shared_epoch as se

    F, CH, At, rvec, rinv, D, Dinv, E, Einv, c0, Q, L, U = fixed
    S0, dX0, dY0, fS, fdX, fdY, status = state
    n, m = Q.shape[0], L.shape[0]
    S, dX, dY = se.affine_iterations(F, c0, rvec, rinv, L, U, S0, dX0, dY0, sc.alpha, sc.K,
                                     sc.iter_prec)
    active = status == se.UNSOLVED
    a2 = active[None]
    S = torch.where(a2, S, S0)
    dX = torch.where(a2, dX, dX0)
    dY = torch.where(a2, dY, dY0)
    st, pri, dua, obj, dobj = bs._batch_check_shared(
        ctx['P'], ctx['A'], Q, L, U, ctx['scal'], ctx['stg'],
        S[:n], S[n:n + m], S[n + m:], dX, dY, False)
    newly = (active & (st != se.UNSOLVED))[None]
    return (S, dX, dY, torch.where(newly, S, fS), torch.where(newly, dX, fdX),
            torch.where(newly, dY, fdY), torch.where(newly[0], st, status), pri, dua, obj, dobj)


_OUT_NAMES = ('S', 'dX', 'dY', 'fS', 'fdX', 'fdY', 'status', 'pri', 'dua', 'obj', 'dobj')


def compare(got, want, tol, status_share=1.0):
    """Statuses identical (in at least ``status_share`` of the columns); every
    other output within ``tol`` times the larger of 1 and the state's
    magnitude, with non-finite entries (the objective of infeasible or
    non-convex columns) in the same places: the state S, dX, dY in every
    column, the captures and the check's results in the columns whose
    statuses agree.  Returns the largest absolute difference."""
    same = got[6] == want[6]
    bad = int((~same).sum())
    if bad > (1 - status_share) * same.numel():
        raise AssertionError(f'statuses differ in {bad} columns')
    scale = max(1.0, float(want[0].abs().max()))
    worst = 0.0
    for k, (name, g, w) in enumerate(zip(_OUT_NAMES, got, want)):
        if name == 'status':
            continue
        if k >= 3:  # per-column results: where the statuses agree
            g, w = (g[:, same], w[:, same]) if g.dim() == 2 else (g[same], w[same])
        fin = torch.isfinite(w) & (w.abs() < 1e20)
        if not torch.equal(fin, torch.isfinite(g) & (g.abs() < 1e20)):
            raise AssertionError(f'{name}: non-finite entries differ')
        if not torch.equal(g[~fin].nan_to_num(), w[~fin].nan_to_num()):
            raise AssertionError(f'{name}: infinite codes differ')
        err = float((g[fin] - w[fin]).abs().max()) if bool(fin.any()) else 0.0
        if err > tol * scale:
            raise AssertionError(f'{name}: max abs error {err} > {tol} * {scale}')
        worst = max(worst, err)
    return worst


def check_own_state(fixed, state, sc, got):
    """The kernel's statuses, objectives and dual objectives are, bit for
    bit, those the plain version's check gives the kernel's own iterates (an
    epoch of K=0 from them): both sum in one stated order, each operation
    rounded on its own (``shared_epoch.ordered_product``, ``ordered_sum``).
    Raises otherwise."""
    from osqp_tpu_torch.ops import shared_epoch as se

    own = se.shared_epoch_plain(*fixed, *got[:3], *state[3:], sc._replace(K=0))
    for k in (6, 9, 10):
        same = (own[k] == got[k]) | (torch.isnan(own[k]) & torch.isnan(got[k]))
        if not bool(same.all()):
            raise AssertionError(f"{int((~same).sum())} of {_OUT_NAMES[k]} differ from the plain "
                                 "check of the kernel's own iterates")


def epoch_bound_ms(B, n, m, itemsize, n_active, peak_flops, peak_bytes, passes=0,
                   tensor_flops=None):
    """Least time for one epoch: iterations of the active columns plus the
    termination check of every column, against one read of each input and
    one write of each output.  ``passes`` bfloat16 products per iteration
    (3 for 'high', 1 for 'default') take the tensor cores' ``tensor_flops``;
    with 0 ('highest') the iterations take ``peak_flops`` like the check."""
    nm, N2 = n + m, n + 2 * m
    iters = K * 2 * nm * N2 * n_active
    check = (4 * nm * n + 4 * n * m) * B
    state = (2 * N2 + 2 * n + 2 * m) * B  # S, fS, dX, dY, fdX, fdY
    reads = state + (nm + n + 2 * m) * B + nm * N2 + nm * n + n * m + 2 * n + 4 * m
    writes = state + 4 * B
    nbytes = (reads + writes) * itemsize + 2 * 4 * B  # + status in and out (int32)
    if passes:
        t_ops = passes * iters / tensor_flops + check / peak_flops
    else:
        t_ops = (iters + check) / peak_flops
    t_bytes = nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes else 'bytes')


def iterated_columns(status, tb):
    """Columns in tiles of ``tb`` that hold an active column: the columns K1
    iterates (a tile whose columns have all terminated skips the
    iterations)."""
    from osqp_tpu_torch.ops import shared_epoch as se

    active = (status == se.UNSOLVED).cpu().numpy()
    tile = np.arange(active.size) // tb
    busy = np.zeros(tile[-1] + 1, dtype=bool)
    np.logical_or.at(busy, tile, active)
    return int(busy[tile].sum())


# The reduced modes' bfloat16 passes per iteration.
PASSES = {'highest': 0, 'high': 3, 'default': 1}
SLAB = (1024, 128, 192)
RAGGED = (333, 13, 19)


def k1_row(card, dtype, shape, tol, iter_prec='highest'):
    """K1 against its plain version at one shape and mode: the launch's plan
    (with the design it picks), the columns it iterates, the kernel's device
    time at K=25 and at K=0 (merge, check and capture only) and the time of
    one iteration between them, CUDA events over back-to-back launches, and
    the plain and unfused epochs' device times.  In the reduced modes
    also one iteration (K=1), held to 1e-5 of the state's scale.  At K=25 the
    tensor cores' sums, in another order than the plain version's, move the
    iterates of the reduced modes by more than an ulp, so a column at the
    edge of its termination test may stop an epoch apart: statuses must
    agree in 99.9% of the columns ('high') or 99% ('default').  'default' is
    also held loosely in value: one bfloat16 pass turns a one-ulp difference
    in S into 2^-8 of that element, so the two drift apart by about 4e-3
    relative; the state must lie within ``tol`` of its scale.  In every mode
    the status, objective and dual objective must be the plain check's of
    the kernel's own iterates, bit for bit (``check_own_state``)."""
    from osqp_tpu_torch.ops import shared_epoch as se

    f32_peak, f64_peak, mem_peak, bf16_peak = peaks(card)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B, n, m = shape
    fixed, state, sc, ctx = epoch_inputs(B, n, m, dtype, seed=0)
    sc = sc._replace(iter_prec=iter_prec)
    halves = se.ITER_PRECS[iter_prec]
    share = {'highest': 1.0, 'high': 0.999, 'default': 0.99}[iter_prec]
    item = torch.empty((), dtype=dtype).element_size()
    want = se.shared_epoch_plain(*fixed, *state, sc)
    unf = unfused_epoch(fixed, state, sc, ctx)
    compare(unf, want, 2e-4 if dtype == torch.float32 else 1e-9)
    plain_ms = device_ms(lambda: se.shared_epoch_plain(*fixed, *state, sc), 5)
    lib_ms = device_ms(lambda: unfused_epoch(fixed, state, sc, ctx), 5)
    n_active = int((state[6] == se.UNSOLVED).sum())
    bound, by = epoch_bound_ms(B, n, m, item, n_active,
                               f32_peak if dtype == torch.float32 else f64_peak, mem_peak,
                               PASSES[iter_prec], bf16_peak)
    p = se.plan_tile(n, m, B, item, n_sm, halves)
    smem = (se.wg_smem_bytes(n, m, halves, p.xc, p.yc, p.tb) if p.design == 'wgmma'
            else se.smem_bytes(n, m, p.tb, p.ks, item, halves))
    plan = dict(p._asdict(), f_mode='resident' if p.ks == n + 2 * m else 'slab', smem=smem)
    row = dict(iter_prec=iter_prec, dtype=str(dtype).replace('torch.', ''), B=B, n=n, m=m)
    if halves:
        sc1 = sc._replace(K=1)
        got1 = se.shared_epoch(*fixed, *state, sc1)
        torch.cuda.synchronize()
        row['max_abs_err_K1'] = compare(got1, se.shared_epoch_plain(*fixed, *state, sc1), 1e-5)
    got = se.shared_epoch(*fixed, *state, sc)
    torch.cuda.synchronize()
    err = compare(got, want, tol, share)
    check_own_state(fixed, state, sc, got)
    reps = 20
    kern = lambda: se.shared_epoch(*fixed, *state, sc)  # noqa: E731
    sc0 = sc._replace(K=0)
    ms = device_ms(kern, reps, name='shared_epoch_kernel')
    ms_k0 = device_ms(lambda: se.shared_epoch(*fixed, *state, sc0), reps,
                      name='shared_epoch_kernel')
    events_ms = cuda_ms(kern, reps)
    row.update(active=n_active, iterated_cols=iterated_columns(state[6], p.tb), plan=plan,
               max_abs_err=err, tol=tol, status_mismatch=int((got[6] != want[6]).sum()),
               state_err=max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])),
               ms=ms, ms_K0=ms_k0, per_iter_us=(ms - ms_k0) / sc.K * 1e3, events_ms=events_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)
    print('shared_epoch vs plain:', json.dumps(row), flush=True)
    return row


def k1_registers():
    """Registers, stack and spills of each K1 instantiation, from the ptxas
    report (-Xptxas -v) that ops/_build.py keeps beside the library.  Fails
    if an instantiation of the register-resident design spills."""
    import re
    from osqp_tpu_torch.ops import _build
    from osqp_tpu_torch.ops import shared_epoch as se

    log = _build.build('shared_epoch').with_suffix('.log').read_text()
    rows, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?(shared_epoch_kernel(?:_wg)?)I(\w+?)EEv",
                          line)
        if entry:
            args = [t or {'f': 'float', 'd': 'double'}.get(c, c)
                    for c, t in re.findall(r'(f|d)|Li(\d+)E', entry.group(2))]
            name = f"{entry.group(1)}<{', '.join(args)}>"
            continue
        frame = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
        if frame and name:
            rows.append(dict(kernel=name, stack=int(frame.group(1)),
                             spill_stores=int(frame.group(2)), spill_loads=int(frame.group(3))))
        used = re.search(r'Used (\d+) registers', line)
        if used and name and rows and rows[-1]['kernel'] == name:
            rows[-1]['registers'] = int(used.group(1))
            name = None
    wg = [r for r in rows if '_wg' in r['kernel']]
    want = sum(1 for h in se.ITER_PRECS.values() if h)  # one a reduced mode
    if len(wg) != want or any('registers' not in r for r in wg):
        raise AssertionError(f'the ptxas report shows {len(wg)} instantiations of the '
                             f'register-resident design, not {want}: {wg}')
    spilled = [r['kernel'] for r in wg if r['spill_stores'] or r['spill_loads']]
    if spilled:
        raise AssertionError(f'the register-resident design spills in {spilled}')
    return rows


def kernel_phase(card):
    """K1 against its plain version: 'highest' at the four shapes, then the
    reduced modes in f32 at the headline, slab and ragged shapes; each K1
    instantiation's registers and spills, and at the headline each reduced
    mode's time over 'highest''s from the same call."""
    # tolerances: f32 sums run in another order and with FMA contraction in
    # the kernel; over 25 iterations of a nonexpansive map that stays within
    # a few 1e-6 of the state's scale, so 2e-4 leaves room; f64 the same at
    # 1e-9.  'high' keeps 2e-4 (its lo halves absorb a one-ulp difference in
    # S to 2^-17); 'default' is held to 5e-2 (see k1_row).
    rows = [k1_row(card, dtype, shape, tol) for dtype, shape, tol in (
        (torch.float32, HEADLINE, 2e-4), (torch.float32, SLAB, 2e-4),
        (torch.float64, RAGGED, 1e-9), (torch.float64, HEADLINE, 1e-9))]
    for iter_prec, tol in (('high', 2e-4), ('default', 5e-2)):
        rows += [k1_row(card, torch.float32, shape, tol, iter_prec)
                 for shape in (HEADLINE, SLAB, RAGGED)]
    print('K1 instantiations:', json.dumps(k1_registers()), flush=True)
    head = {r['iter_prec']: r for r in rows
            if (r['B'], r['n'], r['m']) == HEADLINE and r['dtype'] == 'float32'}
    for iter_prec in ('high', 'default'):
        r = head[iter_prec]
        r['ratio_to_highest'] = r['ms'] / head['highest']['ms']
        print(f"K1 {iter_prec} at the headline: {r['plan']['design']}, {r['ms']:.4f} ms "
              f"(K=0 {r['ms_K0']:.4f}, {r['per_iter_us']:.3f} us an iteration) against "
              f"'highest' {head['highest']['ms']:.4f} ms (K=0 {head['highest']['ms_K0']:.4f}): "
              f"{r['ratio_to_highest']:.3f}", flush=True)
    return rows


def main_path(iter_prec='highest', steps=STEPS, **over):
    """BatchedOSQP setup, cold solve and a ``steps``-step warm rollout at the
    headline shape, f32 on the card, in ``iter_prec``.  Returns the run's
    numbers."""
    from osqp_tpu_torch import BatchedOSQP

    B, n, m = HEADLINE
    P, q, A, l, u = build_shared_problems(B, n, m, seed=0)
    noise = np.random.default_rng(1).standard_normal((STEPS, B, n))
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False, **over)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = BatchedOSQP(dtype=torch.float32, device=DEV, iter_prec=iter_prec)
    s.setup(P, q, A, l, u, **kw)
    r = s.solve()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = [r]
    for k in range(steps):
        s.update(q=q + 0.01 * noise[k])
        results.append(s.solve())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(results=results, setup_cold_s=t1 - t0, warm_s=t2 - t1, P=P, q=q, A=A, l=l,
                u=u, noise=noise, kw=kw, solver=s)


def batched_summary(run, iter_prec, steps, launches):
    """Checks of one batched main-path run and its numbers.  K1 must have
    launched; every returned solution must pass its float64 host check.
    'highest' and 'high' must solve every instance of every step, and
    'highest' lie near the float64 optimum (reference_check); 'default' is
    held to the safety contract: only solved, solved-inaccurate or max-iter
    outcomes."""
    if launches <= 0:
        raise AssertionError(f'the batched main path ({iter_prec}) never launched the '
                             'shared_epoch kernel')
    statuses = np.stack([r.info.status_val for r in run['results']])
    if iter_prec == 'default':
        if not np.isin(statuses, (1, 2, 7)).all():
            raise AssertionError(f"'default': outcomes {np.unique(statuses)}")
    elif not (statuses == 1).all():
        raise AssertionError(f'{iter_prec}: {int((statuses != 1).sum())} instance-solves '
                             'not solved')
    B = HEADLINE[0]
    iters = np.stack([r.info.iter for r in run['results']])
    out = dict(
        iter_prec=iter_prec, B=B, n=HEADLINE[1], m=HEADLINE[2], eps=EPS, dtype='float32',
        steps=steps, setup_and_cold_solve_s=run['setup_cold_s'],
        mean_iters_cold=float(iters[0].mean()), max_iters=int(iters.max()),
        kernel_launches=launches, residual_over_bound=residual_check(run),
        statuses={int(k): int(v) for k, v in zip(*np.unique(statuses, return_counts=True))})
    if steps:
        out.update(warm_rollout_s=run['warm_s'], warm_solves_per_s=B * steps / run['warm_s'],
                   mean_iters_warm=float(iters[1:].mean()))
    if iter_prec == 'highest':
        out['x_err_vs_f64_optimum'] = reference_check(run)
    return out


def profile_rollout(run):
    """Where the warm rollout's time goes: STEPS more warm steps from where
    the main path stopped, under torch.profiler.  Returns the wall time, the
    device's busy time (the sum of its kernels' times; one stream) and idle
    share, the fused kernel's time and launches, and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    s, q, noise = run['solver'], run['q'], run['noise']
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(STEPS):
            s.update(q=q + 0.01 * noise[STEPS - 1 - k])
            s.solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise AssertionError('the profiler recorded no device time')
    epoch = [e for e in kernels if 'shared_epoch_kernel' in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        steps=STEPS, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        device_idle_share=1 - busy_us / 1e3 / wall_ms,
        shared_epoch_ms=sum(e.self_device_time_total for e in epoch) / 1e3,
        shared_epoch_launches=sum(e.count for e in epoch),
        kernel_launches_all=sum(e.count for e in kernels),
        top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    )


def residual_check(run):
    """Every instance of every step satisfies the termination test it was
    accepted by, recomputed on the host in float64 from the returned x and
    y: ||Ax - proj(Ax)|| <= eps_abs + eps_rel max(||Ax||, ||proj(Ax)||) and
    ||Px + q + A'y|| <= eps_abs + eps_rel max(||Px||, ||A'y||, ||q||), in the
    inf-norm, at eps for solved instances and 10 eps for solved-inaccurate
    ones (max-iter instances are not held).  The solver tests ||Ax - z||
    with z in [l, u], which bounds the first from above; 5% and 1e-4 of
    slack cover the float32 rounding of the returned iterates.  Returns the
    largest ratio of residual to bound."""
    P, A, l, u, q = run['P'], run['A'], run['l'], run['u'], run['q']
    worst = 0.0
    for k, r in enumerate(run['results']):
        held = np.isin(r.info.status_val, (1, 2))
        if not held.any():
            continue
        eps = np.where(r.info.status_val[held] == 2, 10.0, 1.0) * run['kw']['eps_abs']
        qk = (q if k == 0 else q + 0.01 * run['noise'][k - 1])[held]
        x = r.x[held].astype(np.float64)
        y = r.y[held].astype(np.float64)
        if A.ndim == 3:  # the vmap engine: each instance its own P and A
            Ah, Ph = A[held], P[held]
            Ax = np.einsum('bmn,bn->bm', Ah, x)
            Px, Aty = np.einsum('bij,bj->bi', Ph, x), np.einsum('bmn,bm->bn', Ah, y)
        else:
            Ax = x @ A.T
            Px, Aty = x @ P.T, y @ A
        proj = np.clip(Ax, l[held], u[held])

        def nrm(V):
            return np.abs(V).max(axis=1)

        pri, dua = nrm(Ax - proj), nrm(Px + qk + Aty)
        eps_pri = eps + eps * np.maximum(nrm(Ax), nrm(proj))
        eps_dua = eps + eps * np.maximum(np.maximum(nrm(Px), nrm(Aty)), nrm(qk))
        ratio = max(float((pri / eps_pri).max()), float((dua / eps_dua).max()))
        if ((pri > 1.05 * eps_pri + 1e-4) | (dua > 1.05 * eps_dua + 1e-4)).any():
            raise AssertionError(f'step {k}: a returned solution fails its termination test '
                                 f'(residual / bound up to {ratio})')
        worst = max(worst, ratio)
    return worst


def reference_check(run, n_check=64):
    """The first ``n_check`` instances of every step against the port's own
    float64 CPU solve of the same QPs to eps 1e-7 (shared or per-instance P
    and A).  The card stops at eps
    1e-3, which on this problem family leaves x up to about 1.5e-2 from the
    optimum (measured with the port on the CPU at B=512 and 2048), so the
    bound is 5e-2: a check that the card solved the same problems, while
    residual_check holds the accuracy.  Returns the largest |x - x*|."""
    from osqp_tpu_torch import BatchedOSQP

    sl = slice(0, n_check)
    P, A = (M[sl] if M.ndim == 3 else M for M in (run['P'], run['A']))
    ref = BatchedOSQP(dtype=torch.float64, device='cpu')
    ref.setup(P, run['q'][sl], A, run['l'][sl], run['u'][sl],
              eps_abs=1e-7, eps_rel=1e-7, max_iter=100000, verbose=False)
    worst = 0.0
    for k, got in enumerate(run['results']):
        if k:
            ref.update(q=run['q'][sl] + 0.01 * run['noise'][k - 1, sl])
        want = ref.solve()
        if not (want.info.status_val == 1).all():
            raise AssertionError('float64 CPU reference did not solve every checked instance')
        worst = max(worst, float(np.abs(got.x[sl] - want.x).max()))
    if worst > 5e-2:
        raise AssertionError(f'x off the float64 optimum by up to {worst} > 5e-2')
    return worst


VMAP_SLAB = (1024, 128, 192)
VMAP_SLAB_WARM = 3
LAYER = (256, 32, 48)
LAYER_EPS = 1e-4
LAYER_REPS = 3


def build_vmap_problems(B, n, m, seed=0):
    """The condensed-MPC family of examples/batched_mpc.py with a plant per
    instance: P_b = L_b L_b'/n + 0.1 I (symmetric to the bit) and A_b, from
    numpy with ``seed``; per-instance q, l, u as in build_shared_problems."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)
    P = np.triu(P) + np.triu(P, 1).transpose(0, 2, 1)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    q = rng.standard_normal((B, n))
    x0 = rng.standard_normal((B, n))
    s0 = rng.random((B, m)) + 0.1
    u = np.einsum('bmn,bn->bm', A, x0) + s0
    l = u - 2 * s0
    return P, q, A, l, u


def vmap_path(dtype, shape, steps, **over):
    """BatchedOSQP on the vmap engine (engine and kkt_method on 'auto'):
    setup, a cold solve and ``steps`` warm update(q) steps with q + 0.01
    noise, on the card.  Returns the run's numbers."""
    from osqp_tpu_torch import BatchedOSQP

    B, n, m = shape
    P, q, A, l, u = build_vmap_problems(B, n, m, seed=0)
    noise = np.random.default_rng(1).standard_normal((max(steps, 1), B, n))
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False, **over)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = BatchedOSQP(dtype=dtype, device=DEV)
    s.setup(P, q, A, l, u, **kw)
    r = s.solve()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = [r]
    for k in range(steps):
        s.update(q=q + 0.01 * noise[k])
        results.append(s.solve())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(results=results, setup_cold_s=t1 - t0, warm_s=t2 - t1, P=P, q=q, A=A, l=l,
                u=u, noise=noise, kw=kw, solver=s, shape=shape, dtype=dtype, steps=steps)


def vmap_summary(run, reference=True):
    """Checks of one vmap-engine run and its numbers: the vmap engine ran,
    every instance of every step solved, every returned solution passes its
    float64 host check, and (``reference``) 64 instances lie within 5e-2 of
    the port's own float64 CPU optimum."""
    s, res = run['solver'], run['results']
    if s._engine != 'vmap':
        raise AssertionError(f'per-instance P and A took the {s._engine} engine')
    statuses = np.stack([r.info.status_val for r in res])
    if not (statuses == 1).all():
        raise AssertionError(f'vmap engine: {int((statuses != 1).sum())} instance-solves '
                             'not solved')
    B, n, m = run['shape']
    iters = np.stack([r.info.iter for r in res])
    steps = run['steps']
    out = dict(
        B=B, n=n, m=m, eps=EPS, dtype=str(run['dtype']).replace('torch.', ''),
        kkt_method=None if s._indirect else s._kkt_method,
        solver_type='indirect' if s._indirect else 'direct',
        steps=steps, setup_and_cold_solve_s=run['setup_cold_s'],
        mean_iters_cold=float(iters[0].mean()), max_iters=int(iters.max()),
        rho_updates_cold=int(res[0].info.rho_updates.sum()),
        rho_updates_warm=[int(r.info.rho_updates.sum()) for r in res[1:]],
        host_syncs=[r.info.host_syncs for r in res],
        residual_over_bound=residual_check(run))
    if steps:
        out.update(warm_s=run['warm_s'], warm_solves_per_s=B * steps / run['warm_s'],
                   mean_iters_warm=float(iters[1:].mean()))
    if reference:
        out['x_err_vs_f64_optimum'] = reference_check(run)
    return out


def _profiled(fn):
    """Run ``fn`` once under torch.profiler; return its result, the wall
    ms and the device kernels' events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if sum(e.self_device_time_total for e in kernels) <= 0:
        raise AssertionError('the profiler recorded no device time')
    return out, wall_ms, kernels


def _profile_numbers(wall_ms, kernels, top=6):
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    heavy = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
                kernel_launches_all=sum(e.count for e in kernels),
                top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                             for e in heavy])


def profile_vmap_step(run):
    """One more warm step of a vmap-engine run under torch.profiler: wall
    and busy ms, idle share, kernel launches per ADMM iteration (the batch
    runs until its last instance stops) and the heaviest kernels."""
    s, q = run['solver'], run['q']
    s.update(q=q - 0.01 * run['noise'][0])
    r, wall_ms, kernels = _profiled(s.solve)
    out = _profile_numbers(wall_ms, kernels)
    admm = int(r.info.iter.max())
    out.update(admm_iters_batch=admm, mean_iters=float(r.info.iter.mean()),
               host_syncs=r.info.host_syncs,
               launches_per_admm_iteration=out['kernel_launches_all'] / admm)
    return out


def vmap_phase():
    """The vmap engine on the card: the per-instance condensed-MPC family at
    the headline shape in float32 ('inv') and float64 ('chol'), cold and 10
    warm steps each, then at B=1024, n=128, m=192 in float32 (cold and 3
    warm), and one cold float64 solve with the indirect solver at the
    headline shape."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        run = vmap_path(dtype, HEADLINE, STEPS)
        summary = vmap_summary(run)
        summary['profile'] = profile_vmap_step(run)
        key = str(dtype).replace('torch.', '')
        print(f'vmap engine ({key}):', json.dumps(summary), flush=True)
        rows[key] = summary
        del run
    run = vmap_path(torch.float32, VMAP_SLAB, VMAP_SLAB_WARM)
    rows['slab'] = vmap_summary(run, reference=False)
    rows['slab']['profile'] = profile_vmap_step(run)
    print('vmap engine (float32, n=128):', json.dumps(rows['slab']), flush=True)
    del run
    run = vmap_path(torch.float64, HEADLINE, 0, solver_type='indirect')
    rows['indirect'] = vmap_summary(run, reference=False)
    rows['indirect']['cg_steps_total_mean'] = float(run['results'][0].info.cg_iters.mean())
    rows['indirect']['cg_steps_max'] = int(run['results'][0].info.cg_iters.max())
    print('vmap engine (float64, indirect):', json.dumps(rows['indirect']), flush=True)
    torch.cuda.empty_cache()
    return rows


class SyncSpy:
    """Counts the vmap engine's host syncs (``core_batched._Counter.host``,
    its only read of the device) for the duration of a ``with`` block."""

    def __enter__(self):
        from osqp_tpu_torch.solver import core_batched as cb

        self._cls, self._orig, self.calls = cb._Counter, cb._Counter.host, 0
        spy = self

        def host(counter, *tensors):
            spy.calls += 1
            return spy._orig(counter, *tensors)

        cb._Counter.host = host
        return self

    def __exit__(self, *exc):
        self._cls.host = self._orig


def rollout_phase(steps=STEPS):
    """batch_qp_solve and mpc_rollout at the headline shape, float32 ('inv'),
    on the per-instance family.  The pure cold solve must give BatchedOSQP's
    statuses and iterations; a ``steps``-step rollout from the setup state
    must give the step-by-step BatchedOSQP run's (update(q), solve()), with
    its results left on the card and no device-to-host copy beyond the
    loop's own per-epoch syncs (counted around the rollout, and the
    profiler's DtoH copies held to that count)."""
    from osqp_tpu_torch import BatchedOSQP
    from osqp_tpu_torch import batch as tb

    B, n, m = HEADLINE
    dt = torch.float32
    P, q, A, l, u = build_vmap_problems(B, n, m, seed=0)
    noise = np.random.default_rng(2).standard_normal((steps, B, n))
    q_seq = q[None] + 0.01 * noise
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False)

    s = BatchedOSQP(dtype=dt, device=DEV).setup(P, q, A, l, u, **kw)
    km = s._kkt_method
    state = (s._data, s._scal, s._rho, s._factor, s._iterates)
    stg = s._core_settings()
    cold = s.solve()

    def dev(v):
        return torch.tensor(v, dtype=dt, device=DEV)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pure = tb.batch_qp_solve(dev(P), dev(q), dev(A), dev(l), dev(u), stg,
                             torch.full((B,), 0.1, dtype=dt, device=DEV), kkt_method=km)
    torch.cuda.synchronize()
    pure_s = time.perf_counter() - t0
    if not (np.array_equal(pure.status.cpu().numpy(), cold.info.status_val)
            and np.array_equal(pure.iters.cpu().numpy(), cold.info.iter)):
        raise AssertionError('batch_qp_solve differs from BatchedOSQP.solve')

    qs = dev(q_seq)

    def roll():
        return tb.mpc_rollout(*state[:2], stg, *state[2:], qs, kkt_method=km)

    torch.cuda.synchronize()
    with SyncSpy() as spy:
        t0 = time.perf_counter()
        _, (x, its, st) = roll()
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
    if x.device.type != torch.device(DEV).type or its.device.type != torch.device(DEV).type:
        raise AssertionError('the rollout returned its results off the card')
    with SyncSpy() as spy2:
        _, wall_ms, kernels = _profiled(roll)
    dtoh = sum(e.count for e in kernels if 'DtoH' in e.key)
    if dtoh > spy2.calls:
        raise AssertionError(f'{dtoh} device-to-host copies in the rollout, more than its '
                             f'{spy2.calls} per-epoch syncs')

    s2 = BatchedOSQP(dtype=dt, device=DEV).setup(P, q, A, l, u, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = []
    for k in range(steps):
        s2.update(q=q_seq[k])
        ref.append(s2.solve())
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    st, its = st.cpu().numpy(), its.cpu().numpy()
    for k, r in enumerate(ref):
        if not (np.array_equal(st[k], r.info.status_val) and np.array_equal(its[k], r.info.iter)):
            raise AssertionError(f'rollout step {k} differs from the step-by-step run')
    if not (st == 1).all():
        raise AssertionError(f'rollout: {int((st != 1).sum())} instance-solves not solved')
    out = dict(B=B, n=n, m=m, eps=EPS, dtype='float32', kkt_method=km, steps=steps,
               batch_qp_solve_s=pure_s, batch_qp_solve_mean_iters=float(cold.info.iter.mean()),
               rollout_s=roll_s, rollout_solves_per_s=B * steps / roll_s,
               step_by_step_s=step_s, step_by_step_solves_per_s=B * steps / step_s,
               mean_iters=float(its.mean()), host_syncs=spy.calls,
               profile_dtoh_copies=dtoh, profile_host_syncs=spy2.calls,
               profile=_profile_numbers(wall_ms, kernels))
    print('batch_qp_solve and mpc_rollout:', json.dumps(out), flush=True)
    return out


def layer_problem(B, n, m, seed=0):
    """The per-instance family as the reference layer's inputs: P's upper
    triangle and all of A as sparsity patterns with per-instance values."""
    P, q, A, l, u = build_vmap_problems(B, n, m, seed)
    P_idx = np.triu_indices(n)
    A_idx = np.nonzero(np.ones((m, n)))
    target = np.random.default_rng(seed + 3).standard_normal((B, n))
    return P_idx, A_idx, P[:, P_idx[0], P_idx[1]], q, A.reshape(B, -1), l, u, target


def layer_phase():
    """The differentiable layers at B=256, n=32, m=48, eps 1e-4:
    nn.torch.OSQP forward and forward+backward on CUDA tensors in float64
    (solves/s over ``LAYER_REPS`` calls; a status other than solved raises),
    its x and the gradients of all five inputs against the same call on CPU
    tensors (within 1e-6 of each gradient's max-norm), a profile of one
    forward+backward; then five steps of examples/qp_layer.py's loop with
    make_qp_layer on the card, whose loss must fall at every step."""
    from osqp_tpu_torch.nn import torch as tnn
    from osqp_tpu_torch.nn.layer import make_qp_layer

    B, n, m = LAYER
    P_idx, A_idx, Pv, q, Av, l, u, target = layer_problem(B, n, m)
    module = tnn.OSQP(P_idx, (n, n), A_idx, (m, n), eps_rel=LAYER_EPS, eps_abs=LAYER_EPS)

    def run(device, backward):
        vals = [torch.tensor(v, dtype=torch.float64, device=device, requires_grad=backward)
                for v in (Pv, q, Av, l, u)]
        x = module(*vals)
        if backward:
            (0.5 * ((x - torch.tensor(target, device=device)) ** 2).sum()).backward()
        if device != 'cpu':
            torch.cuda.synchronize()
        return [x.detach()] + ([v.grad for v in vals] if backward else [])

    run(DEV, True)  # warm-up
    times = {}
    for backward in (False, True):
        t0 = time.perf_counter()
        for _ in range(LAYER_REPS):
            out = run(DEV, backward)
        times[backward] = (time.perf_counter() - t0) / LAYER_REPS
    cpu = run('cpu', True)
    errs = []
    for got, want in zip(out, cpu):
        if got.device.type != torch.device(DEV).type:
            raise AssertionError('a layer result or gradient left the card')
        scale = float(want.abs().max())
        errs.append(float((got.cpu() - want).abs().max()) / max(scale, 1e-300))
    if not max(errs) <= 1e-6:
        raise AssertionError(f'layer card vs cpu: relative errors {errs} > 1e-6')
    _, wall_ms, kernels = _profiled(lambda: run(DEV, True))

    # examples/qp_layer.py's loop, on the card
    rng = np.random.default_rng(0)
    Bs, ns, ms = 8, 6, 4
    L = rng.standard_normal((Bs, ns, ns))
    Pq = 0.1 * np.einsum('bij,bkj->bik', L, L) + 0.2 * np.eye(ns)
    Aq = rng.standard_normal((Bs, ms, ns))
    x0 = rng.standard_normal((Bs, ns))
    s0 = rng.random((Bs, ms))
    uq = np.einsum('bmn,bn->bm', Aq, x0) + s0
    lq = uq - 2 * s0
    tq = rng.standard_normal((Bs, ns))
    layer = make_qp_layer(dtype=torch.float64, eps_abs=1e-8, eps_rel=1e-8)
    fixed = [torch.tensor(v, device=DEV) for v in (Pq, Aq, lq, uq, tq)]

    def loss_fn(qv):
        x = layer(fixed[0], qv, fixed[1], fixed[2], fixed[3])
        return 0.5 * ((x - fixed[4]) ** 2).mean()

    qv = torch.zeros((Bs, ns), dtype=torch.float64, device=DEV)
    losses = [float(loss_fn(qv))]
    for _ in range(5):
        qv = qv.detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn(qv), qv)
        qv = qv.detach() - 0.5 * g
        losses.append(float(loss_fn(qv)))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f'make_qp_layer loop: the loss did not fall at every step: {losses}')
    out = dict(B=B, n=n, m=m, eps=LAYER_EPS, dtype='float64', reps=LAYER_REPS,
               forward_s=times[False], forward_solves_per_s=B / times[False],
               forward_backward_s=times[True], forward_backward_solves_per_s=B / times[True],
               card_vs_cpu_rel_err=dict(zip(('x', 'dP', 'dq', 'dA', 'dl', 'du'), errs)),
               profile_forward_backward=_profile_numbers(wall_ms, kernels),
               qp_layer_losses=losses)
    print('differentiable layers:', json.dumps(out), flush=True)
    return out


SPARSE_N = 1 << 20
SPARSE_WARM = 3
SPARSE_CHECK_N = 16384


def banded_qp(n, seed=0):
    """The banded QP family of examples/huge_banded_qp.py:22-27: tridiagonal
    P, A = I + 0.5 * (shift by -2), box bounds +-1.5."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    P = sparse.diags([np.full(n, 2.0), np.full(n - 1, -0.9), np.full(n - 1, -0.9)],
                     [0, 1, -1]).tocsc()
    q = rng.standard_normal(n)
    A = (sparse.eye(n) + sparse.diags([np.full(n - 2, 0.5)], [-2], shape=(n, n))).tocsc()
    return P, q, A, -1.5 * np.ones(n), 1.5 * np.ones(n)


def kkt_triu(P, A, sigma=1e-6, rho=0.1):
    """The upper triangle (CSC) of the ADMM KKT matrix [[P + sigma I, A'],
    [A, -I / rho]] of a QP's P and A."""
    import scipy.sparse as sparse

    n, m = P.shape[0], A.shape[0]
    K = sparse.bmat([[P + sigma * sparse.eye(n), A.T], [A, -sparse.eye(m) / rho]], format='csc')
    return sparse.triu(K, format='csc')


def dia_bound_ms(D, m_out, n_in, itemsize, peak_flops, peak_bytes):
    """Least time of one DIA matvec: each band value, each entry of v and
    each offset read once, y written once, against two flops per band and
    row."""
    nbytes = (D * m_out + m_out + n_in) * itemsize + 4 * D
    t_ops, t_bytes = 2 * D * m_out / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes else 'bytes')


def _csr(S, dtype, device=DEV):
    """The same matrix as a torch CSR tensor on the card (cuSPARSE SpMV)."""
    S = S.tocsr()
    S.sort_indices()
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter('ignore', UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(S.indptr, dtype=torch.int64, device=device),
            torch.as_tensor(S.indices, dtype=torch.int64, device=device),
            torch.as_tensor(S.data, dtype=dtype, device=device), size=S.shape,
            check_invariants=False)


def _ragged_dia(seed=3):
    """m_out != n_in, about 70 bands (above the JAX package's 64-band scan
    threshold), offsets up to +-5000, as bands and as scipy COO."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    m_out, n_in = 200_003, 150_001
    offs = np.unique(np.concatenate([[0, -5000, 5000], rng.integers(-5000, 5001, 69)]))
    D = offs.size
    bands = rng.standard_normal((D, m_out))
    rows = np.arange(m_out)
    cols = rows[None, :] + offs[:, None]
    bands[(cols < 0) | (cols >= n_in)] = 0.0
    ok = (cols >= 0) & (cols < n_in)
    S = sparse.coo_matrix((bands[ok], (np.broadcast_to(rows, cols.shape)[ok], cols[ok])),
                          shape=(m_out, n_in))
    return bands, tuple(int(o) for o in offs), S


def dia_phase(card):
    """K2 against its plain version on the card.  Returns one row per case."""
    from osqp_tpu_torch.ops import dia_matvec as dm
    from osqp_tpu_torch.ops import spmv
    from osqp_tpu_torch.utils.scaling_host import ruiz_scale_scipy

    f32_peak, f64_peak, mem_peak, _ = peaks(card)
    P, q, A, l, u = banded_qp(SPARSE_N, seed=0)
    P_s, A_s, *_ = ruiz_scale_scipy(P, A, q, l, u, 10)
    rng = np.random.default_rng(7)
    v_host = rng.standard_normal(SPARSE_N)
    cases = []
    for dtype in (torch.float32, torch.float64):
        Pd = spmv.dia_from_scipy(P_s, dtype, DEV)
        Ad = spmv.dia_from_scipy(A_s, dtype, DEV)
        v = torch.as_tensor(v_host, dtype=dtype, device=DEV)
        cases += [('P @ v', Pd, P_s, v), ('A @ v', Ad, A_s, v), ("A' @ y", Ad.T, A_s.T, v)]
    # gram_diag as the polish runs it, in f64: diag(A' diag(w) A) with w =
    # mask / delta for a 0/1 active-set mask and the default delta 1e-6
    w = torch.as_tensor((rng.random(SPARSE_N) < 0.3) / 1e-6, dtype=torch.float64, device=DEV)
    Gd = spmv.DiaMatrix(Ad.bands_t * Ad.bands_t, Ad.offsets_t,
                        torch.zeros((0, SPARSE_N), dtype=torch.float64, device=DEV), (),
                        (SPARSE_N, SPARSE_N))
    gram = Ad.gram_diag(w)
    if not torch.equal(gram, dm.dia_matvec_plain(Gd.bands, Gd.offsets, w)):
        raise AssertionError('gram_diag (f64) differs from its plain version')
    cases.append(('gram_diag', Gd, A_s.T.multiply(A_s.T), w))
    bands, offs, S = _ragged_dia()
    vr = torch.as_tensor(rng.standard_normal(S.shape[1]), device=DEV)
    Sr = spmv.DiaMatrix(torch.as_tensor(bands, device=DEV), offs,
                        torch.zeros((0, S.shape[1]), dtype=torch.float64, device=DEV), (),
                        S.shape)
    cases.append(('ragged', Sr, S, vr))

    # writing 64 MB evicts the 50 MB L2 between timed calls for the cold
    # figure; the main path calls the kernel with its operands mostly in L2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    # tolerances: the kernel rounds each product and each sum on its own, in
    # offset order, as the plain version's separate multiply and add kernels
    # do, so the two should agree bit for bit; the bound of a few ulps of the
    # row scale only admits FMA contraction or another summation order
    rows = []
    for label, M, S_host, v in cases:
        dtype = v.dtype
        offs_t = M._off
        got = dm.dia_matvec(M.bands, offs_t, v)
        torch.cuda.synchronize()
        want = dm.dia_matvec_plain(M.bands, M.offsets, v)
        err = float((got - want).abs().max())
        eps = torch.finfo(dtype).eps
        tol = 4 * eps * max(1.0, float(want.abs().max())) * max(1, len(M.offsets))
        if not (err <= tol):
            raise AssertionError(f'dia_matvec {label} {dtype}: max abs error {err} > {tol}')
        reps = 50
        kern = lambda: dm.dia_matvec(M.bands, offs_t, v)  # noqa: E731
        ms = device_ms(kern, reps, name='dia_matvec_kernel')
        cold_ms = device_ms(kern, 20, name='dia_matvec_kernel', flush=flush.zero_)
        events_ms = cuda_ms(kern, reps)
        plain_ms = device_ms(lambda: dm.dia_matvec_plain(M.bands, M.offsets, v), reps)
        csr = _csr(S_host, dtype)
        lib = csr @ v
        lib_err = float((lib - want).abs().max())
        lib_ms = device_ms(lambda: csr @ v, reps)
        item = torch.empty((), dtype=dtype).element_size()
        D, m_out = M.bands.shape
        bound, by = dia_bound_ms(D, m_out, v.shape[0], item,
                                 f32_peak if dtype == torch.float32 else f64_peak, mem_peak)
        row = dict(case=label, dtype=str(dtype).replace('torch.', ''), D=D, m_out=m_out,
                   n_in=v.shape[0], max_abs_err=err, tol=tol, cusparse_abs_diff=lib_err,
                   ms=ms, cold_l2_ms=cold_ms, back_to_back_events_ms=events_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                   bound_share=bound / ms, bound_share_cold_l2=bound / cold_ms)
        print('dia_matvec vs plain:', json.dumps(row), flush=True)
        rows.append(row)

    # D = 0 (an LP's empty P): zeros, no launch
    before = dm.launches
    z = dm.dia_matvec(torch.zeros((0, 1000), device=DEV), torch.zeros((0,), dtype=torch.int32,
                                                                         device=DEV),
                      torch.ones(1000, device=DEV))
    if dm.launches != before or z.shape != (1000,) or bool(z.any()):
        raise AssertionError('dia_matvec with D = 0 must return zeros without a launch')
    print('dia_matvec D = 0: zeros, no launch', flush=True)
    return rows


def sparse_residual_check(P, A, l, u, q, x, y, eps, hold=True):
    """The termination test of a returned solution, recomputed on the host in
    float64 with scipy (the rule of residual_check): ||Ax - proj(Ax)|| <=
    eps (1 + max(||Ax||, ||proj(Ax)||)) and ||Px + q + A'y|| <= eps (1 +
    max(||Px||, ||A'y||, ||q||)) in the inf-norm, with 5% and 1e-4 of slack.
    Every row of Ax, Px and A'y sums at most three terms of O(1) values, so
    the float32 rounding of the returned x and y moves a row's residual by a
    few 1e-7, far inside the slack, whatever n.  Returns the largest ratio of
    residual to bound; raises if the test fails, unless ``hold`` is false."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    Ax = A @ x
    proj = np.clip(Ax, l, u)
    Px, Aty = P @ x, A.T @ y
    pri = np.abs(Ax - proj).max()
    dua = np.abs(Px + q + Aty).max()
    eps_pri = eps + eps * max(np.abs(Ax).max(), np.abs(proj).max())
    eps_dua = eps + eps * max(np.abs(Px).max(), np.abs(Aty).max(), np.abs(q).max())
    if hold and (pri > 1.05 * eps_pri + 1e-4 or dua > 1.05 * eps_dua + 1e-4):
        raise AssertionError(f'a returned solution fails its termination test: '
                             f'pri {pri} vs {eps_pri}, dua {dua} vs {eps_dua}')
    return max(pri / eps_pri, dua / eps_dua)


def sparse_main_path(dtype=torch.float32, export=None):
    """osqp_tpu_torch.OSQP in sparse mode on the card at n = 2^20: setup, a
    cold solve and SPARSE_WARM warm update(q) steps.  With ``export`` (an
    ``Exports``), the model is exported right after its setup, before its
    first solve (phase 10).  Returns the run."""
    from osqp_tpu_torch import OSQP

    P, q, A, l, u = banded_qp(SPARSE_N, seed=0)
    kw = dict(eps_abs=EPS, eps_rel=EPS, polishing=False, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = OSQP(dtype=dtype, device=DEV, sparse=True)
    s.setup(P=P, q=q, A=A, l=l, u=u, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if export is not None:
        export.run('banded (DIA, K2)', s, (P, q, A, l, u), 'dia_matvec', round_trip=True)
    qs, results, times = [q], [], []
    for k in range(SPARSE_WARM + 1):
        if k:
            qs.append(q * 1.01 ** k)
        t0 = time.perf_counter()
        if k:
            s.update(q=qs[k])
        results.append(s.solve(raise_error=False))
        times.append(time.perf_counter() - t0)
    if export is not None:
        export.check('banded (DIA, K2)', results[0], times[0])
    return dict(solver=s, P=P, A=A, l=l, u=u, qs=qs, results=results, setup_s=setup_s,
                times=times, dtype=dtype)


def sparse_checks(run):
    s = run['solver']._solver
    fmts = (s._sparse_fmt_P, s._sparse_fmt_A)
    if fmts != ('dia', 'dia'):
        raise AssertionError(f'operators are {fmts}, not DIA')
    statuses = [r.info.status for r in run['results']]
    if any(st != 'solved' for st in statuses):
        raise AssertionError(f'sparse main path statuses {statuses}')
    return max(sparse_residual_check(run['P'], run['A'], run['l'], run['u'], qk, r.x, r.y, EPS)
               for qk, r in zip(run['qs'], run['results']))


def sparse_card_vs_cpu():
    """The banded family at n = 16384, float64: the port on the card against
    the port on the CPU, a cold solve and one warm step.  Statuses equal and
    x within 1e-6; iteration counts printed side by side."""
    from osqp_tpu_torch import OSQP

    P, q, A, l, u = banded_qp(SPARSE_CHECK_N, seed=1)
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, polishing=False, verbose=False)
    out = {}
    for dev in (DEV, 'cpu'):
        s = OSQP(dtype=torch.float64, device=dev, sparse=True)
        s.setup(P=P, q=q, A=A, l=l, u=u, **kw)
        r1 = s.solve(raise_error=False)
        s.update(q=1.01 * q)
        out[dev] = (r1, s.solve(raise_error=False))
    rows = []
    for k, (g, w) in enumerate(zip(out[DEV], out['cpu'])):
        if g.info.status != w.info.status:
            raise AssertionError(f'step {k}: card {g.info.status} vs cpu {w.info.status}')
        dx = float(np.abs(g.x - w.x).max())
        if dx > 1e-6:
            raise AssertionError(f'step {k}: x differs by {dx} > 1e-6 between card and cpu')
        rows.append(dict(step=k, status=g.info.status, iter_card=g.info.iter,
                         iter_cpu=w.info.iter, cg_card=g.info.cg_iters,
                         cg_cpu=w.info.cg_iters, x_diff=dx))
    return rows


def profile_sparse(run):
    """One more warm step of the sparse path under torch.profiler: wall
    time, device busy time and idle share, the DIA kernel's time and
    launches, the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    s, q = run['solver'], run['qs'][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.update(q=q * 1.01 ** (SPARSE_WARM + 1))
        r = s.solve(raise_error=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise AssertionError('the profiler recorded no device time')
    dia = [e for e in kernels if 'dia_matvec_kernel' in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        status=r.info.status, iters=r.info.iter, cg_iters=r.info.cg_iters,
        host_syncs=r.info.host_syncs, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        device_idle_share=1 - busy_us / 1e3 / wall_ms,
        dia_matvec_ms=sum(e.self_device_time_total for e in dia) / 1e3,
        dia_matvec_launches=sum(e.count for e in dia),
        kernel_launches_all=sum(e.count for e in kernels),
        top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    )


CHUNK = max(10 * K, 100)  # the chunked solve's chunk at check_termination = K


class PolishSpy:
    """Wraps ``solver.core.polish`` for the duration of a ``with`` block and
    records, around the call the backend makes: the K2 launches, the wall
    time (synchronised), the ADMM residuals the polish was handed and its
    result; with ``profile``, the polish's device time under torch.profiler
    (busy, idle share, K2's time and launches)."""

    def __init__(self, profile=False):
        self.profile = profile
        self.calls = 0

    def __enter__(self):
        from osqp_tpu_torch.solver import core

        self._core, self._orig = core, core.polish
        core.polish = self._call
        return self

    def __exit__(self, *exc):
        self._core.polish = self._orig

    def _call(self, *args):
        from torch.profiler import ProfilerActivity, profile

        from osqp_tpu_torch.ops import dia_matvec as dm

        torch.cuda.synchronize()
        before = dm.launches
        t0 = time.perf_counter()
        if self.profile:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = self._orig(*args)
                torch.cuda.synchronize()
        else:
            out = self._orig(*args)
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - t0
        self.launches = dm.launches - before
        self.admm_res = (float(args[8]), float(args[9]))
        self.result = out
        self.calls += 1
        if self.profile:
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            if busy <= 0:
                raise AssertionError('the profiler recorded no device time in the polish')
            dia = [e for e in kernels if 'dia_matvec_kernel' in e.key]
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            self.profiled = dict(
                wall_ms=self.wall_s * 1e3, device_busy_ms=busy,
                device_idle_share=1 - busy / (self.wall_s * 1e3),
                dia_matvec_ms=sum(e.self_device_time_total for e in dia) / 1e3,
                dia_matvec_launches=sum(e.count for e in dia),
                kernel_launches_all=sum(e.count for e in kernels),
                top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top])
        return out


def sparse_polish_path(sp_run):
    """Polish at full width: the n = 2^20 banded QP, f32 ADMM, cold, then the
    float64 polish (PCG on the masked operator, K2 in f64), on the sparse
    main path's solver with rho reset to its setup value.  The polished
    solution must pass its f64 host termination test, and an accepted polish
    must not raise either residual.  Then one more such solve with the polish
    under the profiler."""
    from osqp_tpu_torch.ops import dia_matvec as dm

    o, P, A, l, u, q = (sp_run[k] for k in ('solver', 'P', 'A', 'l', 'u', 'qs'))
    q = q[0]
    o.update(q=q)
    o.update_settings(rho=0.1, polishing=True, warm_starting=False)
    dm.launches = 0
    with PolishSpy() as spy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = o.solve(raise_error=False)
        wall = time.perf_counter() - t0
    path_launches = dm.launches
    if r.info.status != 'solved' or spy.calls != 1 or r.info.status_polish == 0:
        raise AssertionError(f'polish path: status {r.info.status}, polish calls {spy.calls}, '
                             f'status_polish {r.info.status_polish}')
    if path_launches <= 0 or spy.launches <= 0:
        raise AssertionError('the polish path never launched the dia_matvec kernel')
    ratio = sparse_residual_check(P, A, l, u, q, r.x, r.y, EPS)
    pol = spy.result
    if r.info.status_polish == 1 and not (pol.pri_res <= spy.admm_res[0]
                                          and pol.dua_res <= spy.admm_res[1]):
        raise AssertionError(f'accepted polish raised a residual: {pol.pri_res, pol.dua_res} '
                             f'vs ADMM {spy.admm_res}')
    s = o._solver
    out = dict(n=SPARSE_N, dtype_admm='float32', dtype_polish='float64', eps=EPS,
               delta=o.settings.delta, polish_refine_iter=o.settings.polish_refine_iter,
               admm_iters=r.info.iter, status_polish=r.info.status_polish,
               polish_time_s=r.info.polish_time, polish_wall_s=spy.wall_s, solve_wall_s=wall,
               polish_pcg_steps=s.polish_cg_iters, polish_host_syncs=s.polish_host_syncs,
               polish_dia_launches=spy.launches, path_dia_launches=path_launches,
               admm_pri_dua=spy.admm_res, polished_pri_dua=(float(pol.pri_res),
                                                            float(pol.dua_res)),
               residual_over_bound=ratio)
    with PolishSpy(profile=True) as prof_spy:
        o.solve(raise_error=False)
    out['polish_profile'] = prof_spy.profiled
    return out


def polish_card_vs_cpu():
    """The banded family at n = 16384 in f64 with polishing, on the card and
    on the CPU: the same status_polish, PCG steps within 1%, x and y within
    1e-9."""
    from osqp_tpu_torch import OSQP

    P, q, A, l, u = banded_qp(SPARSE_CHECK_N, seed=1)
    out = {}
    for dev in (DEV, 'cpu'):
        o = OSQP(dtype=torch.float64, device=dev, sparse=True)
        o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=True,
                verbose=False)
        out[dev] = (o.solve(raise_error=False), o._solver.polish_cg_iters)
    (g, cg_g), (w, cg_w) = out[DEV], out['cpu']
    row = dict(status_polish_card=g.info.status_polish, status_polish_cpu=w.info.status_polish,
               iter_card=g.info.iter, iter_cpu=w.info.iter, pcg_card=cg_g, pcg_cpu=cg_w,
               x_diff=float(np.abs(g.x - w.x).max()), y_diff=float(np.abs(g.y - w.y).max()))
    if g.info.status_polish != w.info.status_polish or g.info.status_polish == 0:
        raise AssertionError(f'status_polish card {g.info.status_polish} vs cpu '
                             f'{w.info.status_polish}')
    if abs(cg_g - cg_w) > 0.01 * cg_w:
        raise AssertionError(f'polish PCG steps card {cg_g} vs cpu {cg_w}: more than 1% apart')
    if row['x_diff'] > 1e-9 or row['y_diff'] > 1e-9:
        raise AssertionError(f'polished x or y differ between card and cpu: {row}')
    return row


def random_sparse_qp(n, m, density, seed=0):
    """tests/test_sparse_mode.py::_random_sparse_qp: a random sparse QP with
    a strictly convex P and a feasible box around A x0."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    Pt = sparse.random(n, n, density=density, random_state=rng)
    P = (Pt.T @ Pt + 0.1 * sparse.eye(n)).tocsc()
    q = rng.standard_normal(n)
    A = sparse.random(m, n, density=density, random_state=rng, format='csc')
    A = A + 0.01 * sparse.random(m, n, density=5.0 / n, random_state=rng)
    A = A.tocsc()
    x0 = rng.standard_normal(n)
    s0 = rng.random(m) + 0.1
    u = A @ x0 + s0
    l = u - 2 * s0
    return P, q, A, l, u


def dense_polish_path(density, n=2000, m=3000):
    """The dense direct path in f32 with polishing on a random sparse QP: the
    polish factors its Schur form by Cholesky in f64 on the card.  The
    returned solution must pass its f64 host termination test.  At density
    0.01 the polish is rejected (the JAX package rejects it too, in f64) and
    the line search runs at full width; at 0.002 it is accepted."""
    from osqp_tpu_torch import OSQP

    P, q, A, l, u = random_sparse_qp(n, m, density, seed=0)
    o = OSQP(dtype=torch.float32, device=DEV, sparse=False)
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=True, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = o.solve(raise_error=False)
    wall = time.perf_counter() - t0
    if r.info.status != 'solved' or r.info.status_polish == 0:
        raise AssertionError(f'dense polish: {r.info.status}, status_polish '
                             f'{r.info.status_polish}')
    ratio = sparse_residual_check(P, A, l, u, q, r.x, r.y, EPS)
    return dict(n=n, m=m, density=density, dtype_admm='float32', admm_iters=r.info.iter,
                status_polish=r.info.status_polish, polish_time_s=r.info.polish_time,
                solve_wall_s=wall, residual_over_bound=ratio)


def polish_random():
    """tests/problems.py::polish_random (n = 30, m = 50)."""
    import scipy.sparse as sparse

    np.random.seed(6)
    n, m = 30, 50
    Pt = sparse.random(n, n)
    P = (Pt.T @ Pt).tocsc()
    q = np.random.randn(n)
    A = sparse.csc_matrix(np.random.randn(m, n))
    l = -3 + np.random.randn(m)
    u = 3 + np.random.randn(m)
    return P, q, A, l, u


def rejected_polish():
    """A rejected polish (delta = 1, no refinement) on a small QP in f64 on
    the card: status_polish -1 and the line-search family, whose t[0] = 0
    sample is the returned ADMM solution."""
    from osqp_tpu_torch import OSQP

    P, q, A, l, u = polish_random()
    o = OSQP(dtype=torch.float64, device=DEV)
    o.setup(P=P, q=q, A=A, l=l, u=u, polishing=True, delta=1.0, polish_refine_iter=0,
            verbose=False)
    r = o.solve(raise_error=False)
    ls = r.linesearch
    if r.info.status != 'solved' or r.info.status_polish != -1 or ls is None:
        raise AssertionError(f'rejected polish: {r.info.status}, {r.info.status_polish}, '
                             f'line search {ls is not None}')
    x0_err = float(np.abs(ls.X[0] - r.x).max())
    if ls.t[0] != 0.0 or ls.X.shape != (1000, P.shape[0]) or x0_err > 1e-12:
        raise AssertionError(f'line search: t[0] {ls.t[0]}, X {ls.X.shape}, '
                             f'|X[0] - x| {x0_err}')
    return dict(status_polish=-1, samples=ls.t.size, t_last=float(ls.t[-1]), x0_err=x0_err)


def time_limit_path(sp_run):
    """time_limit = 0.05 s on the n = 2^20 QP at eps 1e-9: the solve stops
    after a whole number of chunks with TIME_LIMIT_REACHED."""
    o = sp_run['solver']
    o.update_settings(rho=0.1, polishing=False, warm_starting=False, eps_abs=1e-9,
                      eps_rel=1e-9, time_limit=0.05)
    r = o.solve(raise_error=False)
    if r.info.status != 'run time limit reached' or r.info.iter % CHUNK \
            or not np.isfinite(r.x).all():
        raise AssertionError(f'time_limit: {r.info.status} after {r.info.iter} iterations')
    return dict(status=r.info.status, iters=r.info.iter, chunk=CHUNK,
                solve_time_s=r.info.solve_time)


def sigint_path(sp_run, chunk_s):
    """A real SIGINT on the n = 2^20 QP (time_limit = 1e9, eps 1e-9): the
    backend's between-chunk hook starts a timer when the first chunk has
    completed, and the timer sends SIGINT half a chunk later, so the signal
    lands inside the second chunk however long the first one took.  The
    solve returns 'interrupted' with the last completed chunk's finite
    iterates."""
    import os
    import signal
    import threading

    from osqp_tpu_torch import backend

    o = sp_run['solver']
    o.update_settings(rho=0.1, time_limit=1e9, max_iter=20 * CHUNK)
    timer = threading.Timer(0.5 * chunk_s, os.kill, (os.getpid(), signal.SIGINT))
    polls, hook = [], backend._poll_interrupt

    def arm_after_first_chunk():
        # called before each chunk: the second call follows the first chunk
        polls.append(None)
        if len(polls) == 2:
            timer.start()

    old = signal.signal(signal.SIGINT, signal.default_int_handler)
    backend._poll_interrupt = arm_after_first_chunk
    try:
        t0 = time.perf_counter()
        r = o.solve(raise_error=False)
        wall = time.perf_counter() - t0
    finally:
        timer.cancel()
        backend._poll_interrupt = hook
        signal.signal(signal.SIGINT, old)
    if r.info.status != 'interrupted' or r.info.iter < CHUNK or r.info.iter % CHUNK \
            or not np.isfinite(r.x).all():
        raise AssertionError(f'SIGINT: {r.info.status} after {r.info.iter} iterations')
    return dict(status=r.info.status, iters=r.info.iter, timer_s=0.5 * chunk_s,
                solve_wall_s=wall)


def verbose_path(sp_run, max_iter=600):
    """One verbose cold solve at n = 2^20 (eps 1e-9, max_iter 600): its
    console output is printed, and it must hold floor(iter / 200) iteration
    rows."""
    import contextlib
    import io
    import re

    o = sp_run['solver']
    o.update_settings(rho=0.1, time_limit=0, max_iter=max_iter, verbose=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = o.solve(raise_error=False)
    o.update_settings(verbose=False)
    text = buf.getvalue()
    print(text, end='', flush=True)
    rows = [x for x in text.splitlines() if re.match(r'^ *\d+  -?\d', x)]
    if len(rows) != r.info.iter // 200 or 'status:' not in text:
        raise AssertionError(f'verbose: {len(rows)} rows for {r.info.iter} iterations')
    return dict(status=r.info.status, iters=r.info.iter, rows=len(rows))



# ---------------------------------------------------------------------------
# The ELL, BSR and BCOO single-QP paths: K3, K4, K2 and cuSPARSE
# ---------------------------------------------------------------------------

FAMILY_WARM = 2
PORTFOLIO_MAX_ITER = 300  # the Portfolio cold solve's cut (its default is 4000)
ELL_N = 1 << 20
CLUSTER_NSB = 1024
PORTFOLIO_N, PORTFOLIO_K = 100_000, 1_000


def ell_family(n, seed=0):
    """The even-row random graph QP: P = S + S' + diag(2 rowsum|S + S'| + 1),
    S with 4 off-diagonal N(0, 1) entries per row at uniform random columns;
    A = I + R, R with 7 entries per row at uniform random columns, N(0, 1)
    0.5 / 7; l = -1.5, u = 1.5, q ~ N(0, 1)."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(1, n, rows.size)) % n
    S = sparse.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    S = (S + S.T).tocsr()
    P = (S + sparse.diags(2 * np.asarray(abs(S).sum(axis=1)).ravel() + 1)).tocsc()
    rows = np.repeat(np.arange(n), 7)
    cols = rng.integers(0, n, rows.size)
    R = sparse.coo_matrix((rng.standard_normal(rows.size) * (0.5 / 7), (rows, cols)),
                          shape=(n, n))
    A = (sparse.eye(n, format='csc') + R.tocsc()).tocsc()
    q = rng.standard_normal(n)
    return P, q, A, -1.5 * np.ones(n), 1.5 * np.ones(n)


def _super_clustered(nsb, pairs, seed, scale):
    """tests/test_spmv.py::_super_clustered built as COO, with the same draws
    in the same order: dense 128 x 128 blocks on the diagonal (symmetrized)
    and at each pair (i, j), with B' at (j, i)."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    ij = np.array([(i, i) for i in range(nsb)] + sorted(pairs), dtype=np.int64)
    B = rng.standard_normal((len(ij), 128, 128)) * scale
    B[:nsb] = (B[:nsb] + B[:nsb].transpose(0, 2, 1)) / 2
    blocks = np.concatenate([B, B[nsb:].transpose(0, 2, 1)])
    bi = np.concatenate([ij[:, 0], ij[nsb:, 1]])
    bj = np.concatenate([ij[:, 1], ij[nsb:, 0]])
    r = np.arange(128)
    rows = np.broadcast_to(bi[:, None, None] * 128 + r[None, :, None], blocks.shape)
    cols = np.broadcast_to(bj[:, None, None] * 128 + r[None, None, :], blocks.shape)
    n = nsb * 128
    return sparse.coo_matrix((blocks.ravel(), (rows.ravel(), cols.ravel())),
                             shape=(n, n)).tocsc()


def clustered_family(nsb, n_pairs, seed=0):
    """tests/test_spmv.py::_clustered_qp (its draws, in its order): P and A
    scattered dense 128 x 128 super-blocks plus the identity."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    n = nsb * 128
    pairs = set()
    while len(pairs) < n_pairs:
        i, j = sorted(rng.integers(nsb, size=2))
        if i != j:
            pairs.add((int(i), int(j)))
    P = (_super_clustered(nsb, pairs, seed, 1.0 / (128 * 8)) + sparse.eye(n)).tocsc()
    A = (_super_clustered(nsb, pairs, seed + 1, 1.0 / 64) + sparse.eye(n)).tocsc()
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    return P, q, A, u - 2 * s0, u


def portfolio_family(n, k, seed=0):
    """The Portfolio problem of the OSQP benchmark suite (Stellato et al.,
    Math. Prog. Comp. 2020; osqp_benchmarks problem_classes/portfolio.py):
    minimize x'Dx + y'y - mu'x over (x, y) subject to y = F'x, 1'x = 1,
    0 <= x <= 1; F (n, k) of density 0.5 with N(0, 1) values, D_ii ~
    U[0, sqrt(k)], mu ~ N(0, 1)."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(seed)
    fr, fc = np.nonzero(rng.random((k, n)) < 0.5)  # F' pattern
    fv = rng.standard_normal(fr.size)
    D = rng.random(n) * np.sqrt(k)
    mu = rng.standard_normal(n)
    P = sparse.diags(np.concatenate([2 * D, 2 * np.ones(k)])).tocsc()
    q = np.concatenate([-mu, np.zeros(k)])
    rows = np.concatenate([np.zeros(n, np.int64), fr + 1, np.arange(1, k + 1),
                           np.arange(k + 1, k + 1 + n)])
    cols = np.concatenate([np.arange(n), fc, n + np.arange(k), np.arange(n)])
    vals = np.concatenate([np.ones(n), fv, -np.ones(k), np.ones(n)])
    A = sparse.coo_matrix((vals, (rows, cols)), shape=(1 + k + n, n + k)).tocsc()
    l = np.concatenate([[1.0], np.zeros(k + n)])
    u = np.concatenate([[1.0], np.zeros(k), np.ones(n)])
    return P, q, A, l, u


def gap_over_bound(info, eps):
    """The solver's duality gap over about its bound, eps (1 + max(|obj|,
    |dual obj|)): the test that check_dualgap (on by default) adds to the
    residuals' and that ``sparse_residual_check`` does not make."""
    bound = eps + eps * max(abs(float(info.obj_val)), abs(float(info.dual_obj_val)))
    return abs(float(info.duality_gap)) / bound


def _launch_counters():
    from osqp_tpu_torch.ops import bsr_matvec as bm
    from osqp_tpu_torch.ops import dia_matvec as dm
    from osqp_tpu_torch.ops import ell_matvec as em

    return dict(dia_matvec=dm, ell_matvec=em, bsr_matvec=bm)


def profile_family(o, q):
    """One warm update(q) + solve under torch.profiler: wall, device busy and
    idle share, kernel count, and each operator product's device time and
    share of busy time (the port's three kernels by name, cuSPARSE's by its
    namespace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        o.update(q=q)
        r = o.solve(raise_error=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        raise AssertionError('the profiler recorded no device time')
    products = {}
    for label, key in (('dia_matvec', 'dia_matvec_kernel'), ('ell_matvec', 'ell_matvec_kernel'),
                       ('bsr_matvec', 'bsr_matvec_kernel'), ('cusparse', 'cusparse')):
        evs = [e for e in kernels if key in e.key.lower()]
        ms = sum(e.self_device_time_total for e in evs) / 1e3
        if evs:
            products[label] = dict(ms=ms, launches=sum(e.count for e in evs), share=ms / busy)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(status=r.info.status, iters=r.info.iter, cg_iters=r.info.cg_iters,
                host_syncs=r.info.host_syncs, wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall_ms,
                kernel_launches_all=sum(e.count for e in kernels), products=products,
                top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                             for e in top])


def family_path(name, build, expect, kernel, solved=True, profile_iters=None, warm=FAMILY_WARM,
                export=None, max_iter=None):
    """osqp_tpu_torch.OSQP(sparse=True) on the card in float64, eps 1e-3, the
    format ladder on auto and every other setting at its default: setup, a
    cold solve and ``warm`` warm update(q * 1.01^k) steps, with every
    kernel's launch count set to 0 just before and read just after.  The
    formats must be ``expect`` and ``kernel`` must have launched.  With
    ``solved``, every step must be solved and pass its f64 host
    termination test; without it (the Portfolio family, which the indirect
    solver does not bring to eps 1e-3 within the default 4000 iterations:
    ROADMAP.md Queue 3), every step must end solved or at the iteration
    limit with finite iterates, a solved step must pass the host test, and
    each step's ratios of residual and of duality gap to their bounds are
    reported.  Then a profile of one more warm step, cut to
    ``profile_iters`` iterations when given.  With ``export`` (an
    ``Exports``), the model is exported right after its setup, before its
    first solve (phase 10), with the launch counts kept apart.  ``max_iter``
    cuts the solves' iteration limit (default 4000).
    Returns the summary and the solver."""
    from osqp_tpu_torch import OSQP

    t0 = time.perf_counter()
    P, q, A, l, u = build()
    gen_s = time.perf_counter() - t0
    counters = _launch_counters()
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = OSQP(device=DEV, sparse=True)
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=False, verbose=False,
            **({} if max_iter is None else dict(max_iter=max_iter)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if export is not None:
        export.run(f'{name} ({kernel})', o, (P, q, A, l, u), kernel)
    qs, results, times = [], [], []
    for k in range(warm + 1):
        qs.append(q * 1.01 ** k)
        t0 = time.perf_counter()
        if k:
            o.update(q=qs[k])
        results.append(o.solve(raise_error=False))
        times.append(time.perf_counter() - t0)
    launches = {k: mod.launches for k, mod in counters.items()}
    if export is not None:
        export.check(f'{name} ({kernel})', results[0], times[0])
    fmts = (o._solver._sparse_fmt_P, o._solver._sparse_fmt_A)
    if fmts != expect:
        raise AssertionError(f'{name}: formats {fmts}, expected {expect}')
    if launches[kernel] <= 0:
        raise AssertionError(f'{name}: the {kernel} kernel never launched')
    statuses = [r.info.status for r in results]
    allowed = ('solved',) if solved else ('solved', 'maximum iterations reached')
    if any(st not in allowed for st in statuses) or not all(
            np.isfinite(r.x).all() and np.isfinite(r.y).all() for r in results):
        raise AssertionError(f'{name}: statuses {statuses}')
    ratios = [sparse_residual_check(P, A, l, u, qk, r.x, r.y, EPS, hold=r.info.status == 'solved')
              for qk, r in zip(qs, results)]
    summary = dict(
        family=name, n=P.shape[0], m=A.shape[0], nnz_P=int(P.nnz), nnz_A=int(A.nnz),
        max_iter=max_iter or 4000,
        dtype='float64', eps=EPS, formats=list(fmts), generate_s=gen_s, setup_s=setup_s,
        cold_solve_s=times[0], warm_solve_s=times[1:], statuses=statuses,
        admm_iters=[r.info.iter for r in results], cg_steps=[r.info.cg_iters for r in results],
        host_syncs=[r.info.host_syncs for r in results], launches=launches,
        residual_over_bound=ratios,
        gap_over_bound=[gap_over_bound(r.info, EPS) for r in results],
        device_mem_gb=torch.cuda.memory_allocated() / 1e9)
    if profile_iters:
        o.update_settings(max_iter=profile_iters)
    summary['profile'] = profile_family(o, q * 1.01 ** (warm + 1))
    summary['profile']['max_iter'] = profile_iters
    print(f'{name} path:', json.dumps(summary), flush=True)
    return summary, o


def _ell_csr(data, cols, n):
    """The ELL matrix as a torch CSR tensor on the card (pads dropped)."""
    m, K = data.shape
    keep = data != 0
    rows = torch.arange(m, device=data.device)[:, None].expand(m, K)[keep]
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols[keep].long()]), data[keep], (m, n),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _bsr_csr(blocks, bcols, m, n):
    """The block-ELL matrix as a torch CSR tensor on the card (zeros
    dropped)."""
    b, k, r, c = blocks.nonzero().unbind(1)
    idx = torch.stack([b * 8 + r, bcols[b, k].long() * 128 + c])
    coo = torch.sparse_coo_tensor(idx, blocks[b, k, r, c], (m, n), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _csr_ell(csr):
    """A CSR tensor on the card as ELL arrays (data, cols) padded to its
    longest row, for timing K3 on another family's matrix."""
    crow, col, val = csr.crow_indices(), csr.col_indices(), csr.values()
    m = crow.numel() - 1
    counts = crow[1:] - crow[:-1]
    K = max(int(counts.max()), 1)
    row = torch.repeat_interleave(torch.arange(m, device=crow.device), counts)
    pos = torch.arange(val.numel(), device=crow.device) - crow[:-1][row]
    data = torch.zeros((m, K), dtype=val.dtype, device=val.device)
    cols = torch.zeros((m, K), dtype=torch.int32, device=val.device)
    data[row, pos] = val
    cols[row, pos] = col.int()
    return data, cols


def matvec_row(card, label, name, kern, plain, abs_plain, csr, v, nbytes, flops, padded_bytes,
               flush, **shape):
    """One kernel against its plain version on the card: the largest error
    relative to each row's sum of |a| |v| (f32 1e-5, f64 1e-12: the kernel
    sums in another order, with FMA), device ms with the L2 warm and cold,
    the plain version's and cuSPARSE's (``csr @ v``) device ms (all from
    CUDA events, ``event_ms``), and the bound.  ``nbytes`` and ``flops`` are
    what the product needs (stored entries that are not padding, v and y
    once): they give ``bound_ms``.  ``padded_bytes`` counts the padded arrays
    the kernel reads; ``padded_bound_ms`` is their time alone."""
    f32_peak, f64_peak, mem_peak, _ = peaks(card)
    dtype = v.dtype
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    diff = (got - want).abs()
    scale = abs_plain().clamp(min=torch.finfo(dtype).tiny)  # rows of pads only: 0
    rel = float((diff / scale).max()) if diff.numel() else 0.0
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    if not rel <= tol:
        raise AssertionError(f'{name} {label} {dtype}: error {rel} of the row scale > {tol}')
    lib_diff = float((csr @ v - want).abs().max())
    t_bytes = nbytes / mem_peak
    t_ops = flops / (f32_peak if dtype == torch.float32 else f64_peak)
    ms = event_ms(kern, 50)
    cold = event_ms(kern, 20, flush=flush.zero_)
    row = dict(case=label, dtype=str(dtype).replace('torch.', ''), **shape,
               max_abs_err=float(diff.max()), max_rel_err=rel, tol=tol,
               cusparse_abs_diff=lib_diff, ms=ms, cold_l2_ms=cold,
               plain_ms=event_ms(plain, 20), library_ms=event_ms(lambda: csr @ v, 50),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by='operations' if t_ops > t_bytes else 'bytes',
               padded_bound_ms=padded_bytes / mem_peak * 1e3)
    row.update(bound_share=row['bound_ms'] / ms, bound_share_cold_l2=row['bound_ms'] / cold,
               ms_over_library=ms / row['library_ms'])
    print(f'{name} vs plain:', json.dumps(row), flush=True)
    return row


def ell_touched_bytes(lens, K, item, gran):
    """Bytes of the ``gran``-byte units (64: memory bursts; 32: L2 sectors)
    that hold the stored entries of ELL rows of ``lens`` entries at a stride
    of K slots: each row's data (``item`` bytes a slot) and int32 columns,
    counted per array and per row.  A padded row's entries share their units
    with pads, so this is more than the entries' own bytes whenever K
    exceeds the row."""
    r = torch.arange(lens.numel(), device=lens.device, dtype=torch.int64)
    n_slots = lens.long()
    total = 0
    for size in (item, 4):
        start = r * K * size
        end = start + n_slots * size
        total += int(torch.where(n_slots > 0, (end - 1) // gran - start // gran + 1, 0).sum())
    return total * gran


def nonfinite_row(name, label, kern, plain, v, idx, val):
    """One kernel call with ``v[idx] = val`` against its plain version: the
    NaN positions must be equal (the kernel skips pads and sets the rows the
    plain version's pads would make NaN)."""
    w = v.clone()
    w[idx] = val
    got, want = kern(w), plain(w)
    torch.cuda.synchronize()
    row = dict(case=label, dtype=str(v.dtype).replace('torch.', ''), index=idx, value=str(val),
               nan_rows=int(want.isnan().sum()), rows=int(want.numel()),
               nan_positions_equal=bool(torch.equal(got.isnan(), want.isnan())))
    print(f'{name} non-finite v:', json.dumps(row), flush=True)
    if not row['nan_positions_equal']:
        raise AssertionError(f'{name} {label}: NaN positions differ from the plain version '
                             f'for v[{idx}] = {val}')
    return row


def ell_rows(card, o, flush):
    """K3 on the ELL path's own operators (P, A and A', scaled, f64 and
    f32), with the operator's own counts and lanes per row, and on ragged
    arrays: K = 3 and 13 at m != n, K = 40 (over a warp), with pads at
    column 0; then each f64 operator at G = 4, 8, 16 and 32 lanes per row
    (one line each), and a non-finite v[0] on each.  Beside the bound over
    the entries each row reports the 64-byte bursts and 32-byte sectors
    those entries lie in (``ell_touched_bytes``), one 32-byte sector per
    gather of v, and ``burst_bound_ms``: the bursts, lens, v and y over the
    card's memory rate."""
    from osqp_tpu_torch.ops import ell_matvec as em

    d = o._solver._data
    rng = np.random.default_rng(11)
    cases = [('P @ v', d.P), ('A @ v', d.A), ("A' @ y", d.A.T)]
    arrays = []
    for dtype in (torch.float64, torch.float32):
        for label, M in cases:
            M = M.astype(dtype)
            arrays.append((label, M.data, M.cols, M.shape[1], M.lens, M.log2g))
    for m, n, K in ((200_003, 150_001, 3), (150_001, 200_003, 13), (100_003, 90_001, 40)):
        cols = rng.integers(1, n, (m, K)).astype(np.int32)
        data = rng.standard_normal((m, K))
        pad = rng.random((m, K)) < 0.2
        data[pad], cols[pad] = 0.0, 0
        for dtype in (torch.float64, torch.float32):
            data_d = torch.as_tensor(data, dtype=dtype, device=DEV)
            cols_d = torch.as_tensor(cols, device=DEV)
            lens = em.row_lens(data_d, cols_d)
            arrays.append((f'ragged K={K}', data_d, cols_d, n, lens, em.lanes_log2(lens)))
    rows = []
    for label, data, cols, n, lens, log2g in arrays:
        m, K = data.shape
        nnz = int((data != 0).sum())  # pads are zero data at column 0
        v = torch.as_tensor(rng.standard_normal(n), dtype=data.dtype, device=DEV)
        item = data.element_size()
        bursts = ell_touched_bytes(lens, K, item, 64)
        rows.append(matvec_row(
            card, label, 'ell_matvec', lambda: em.ell_matvec(data, cols, v, lens, log2g),
            lambda: em.ell_matvec_plain(data, cols, v),
            lambda: em.ell_matvec_plain(data.abs(), cols, v.abs()), _ell_csr(data, cols, n), v,
            nnz * (item + 4) + (m + n) * item, 2 * nnz, m * K * (item + 4) + (m + n) * item,
            flush, m=m, n=n, K=K, nnz=nnz, lens_mean=float(lens.double().mean()),
            lanes_per_row=1 << log2g, burst_mb=bursts / 1e6,
            sector_mb=ell_touched_bytes(lens, K, item, 32) / 1e6, gather_mb=32 * nnz / 1e6,
            burst_bound_ms=(bursts + m * 4 + (m + n) * item) / peaks(card)[2] * 1e3))
    for label, M in cases:
        v = torch.as_tensor(rng.standard_normal(M.shape[1]), device=DEV)
        lib = next(r['library_ms'] for r in rows
                   if r['case'] == label and r['dtype'] == 'float64')
        for log2g in range(2, 6):
            width = dict(case=label, dtype='float64', K=M.data.shape[1],
                         lens_mean=float(M.lens.double().mean()), lanes_per_row=1 << log2g,
                         rule_lanes_per_row=1 << M.log2g,
                         ms=event_ms(lambda: em.ell_matvec(M.data, M.cols, v, M.lens, log2g), 50),
                         library_ms=lib)
            print('ell_matvec width:', json.dumps(width), flush=True)
        for idx, val in ((0, float('inf')), (0, float('nan'))):
            nonfinite_row('ell_matvec', label,
                          lambda w: em.ell_matvec(M.data, M.cols, w, M.lens, M.log2g),
                          lambda w: em.ell_matvec_plain(M.data, M.cols, w), v, idx, val)
    return rows


def bsr_rows(card, o, flush):
    """K4 on the BSR path's own A and A' (scaled, f64 and f32) with the
    operator's own block counts, and on a ragged 1000 x 1000 matrix
    (multiples of neither 8 nor 128); then a NaN at v[5] (block-column 0,
    which padding blocks multiply) and at v[200] on the f64 A."""
    import scipy.sparse as sparse

    from osqp_tpu_torch.ops import bsr_matvec as bm
    from osqp_tpu_torch.ops import spmv

    A = o._solver._data.A
    rng = np.random.default_rng(12)
    S = sparse.random(1000, 1000, density=0.05, random_state=rng, format='csc')
    arrays = []
    for dtype in (torch.float64, torch.float32):
        for label, M in (('A @ v', A.astype(dtype)), ("A' @ y", A.T.astype(dtype)),
                         ('ragged 1000 x 1000', spmv.bsr_from_scipy(S, dtype, DEV))):
            arrays.append((label, M.blocks, M.bcols, M.nblk, M.shape))
    rows = []
    for label, blocks, bcols, nblk, (m, n) in arrays:
        nbr, Kb = bcols.shape
        nb = int(blocks.flatten(2).ne(0).any(-1).sum())  # pads are zero blocks
        v = torch.as_tensor(rng.standard_normal(n), dtype=blocks.dtype, device=DEV)
        item = blocks.element_size()
        rows.append(matvec_row(
            card, label, 'bsr_matvec', lambda: bm.bsr_matvec(blocks, bcols, v, m, nblk),
            lambda: bm.bsr_matvec_plain(blocks, bcols, v, m),
            lambda: bm.bsr_matvec_plain(blocks.abs(), bcols, v.abs(), m),
            _bsr_csr(blocks, bcols, m, n), v,
            nb * (1024 * item + 4) + (m + n) * item, 2 * nb * 1024,
            nbr * Kb * (1024 * item + 4) + (m + n) * item, flush,
            m=m, n=n, nbr=nbr, Kb=Kb, blocks=nb, nblk_mean=float(nblk.double().mean())))
    v = torch.as_tensor(rng.standard_normal(A.shape[1]), device=DEV)
    for idx in (5, 200):
        nonfinite_row('bsr_matvec', 'A @ v',
                      lambda w: bm.bsr_matvec(A.blocks, A.bcols, w, A.shape[0], A.nblk),
                      lambda w: bm.bsr_matvec_plain(A.blocks, A.bcols, w, A.shape[0]), v, idx,
                      float('nan'))
    return rows


def ladder_rows(o, family):
    """The format ladder on the card for one path's scaled operators, f64:
    device ms per product of each format that fits in 8 GB (the port's
    kernels on their own arrays; ELL also built from the matrix where its
    padded rows fit) beside cuSPARSE's CSR of the same matrix (``event_ms``)."""
    from osqp_tpu_torch.ops import ell_matvec as em
    from osqp_tpu_torch.ops import spmv

    rng = np.random.default_rng(13)
    out = []
    d = o._solver._data
    for label, M in (('P', d.P), ('A', d.A), ("A'", d.A.T)):
        m, n = M.shape
        v = torch.as_tensor(rng.standard_normal(n), device=DEV)
        if isinstance(M, spmv.CooMatrix):
            csr = M.csr
        elif isinstance(M, spmv.EllMatrix):
            csr = _ell_csr(M.data, M.cols, n)
        elif isinstance(M, spmv.BsrMatrix):
            csr = _bsr_csr(M.blocks, M.bcols, m, n)
        else:  # DIA: every band's in-range non-zeros
            rows = torch.arange(m, device=DEV)
            idx, vals = [], []
            for k, off in enumerate(M.offsets):
                c = rows + off
                keep = (c >= 0) & (c < n) & (M.bands[k] != 0)
                idx.append(torch.stack([rows[keep], c[keep]]))
                vals.append(M.bands[k][keep])
            csr = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals), (m, n),
                                          check_invariants=False).coalesce().to_sparse_csr()
        row = dict(family=family, operator=label, m=m, n=n, nnz=int(csr.values().numel()),
                   format=type(M).__name__, ms=event_ms(lambda: M @ v, 20),
                   cusparse_csr_ms=event_ms(lambda: csr @ v, 20))
        counts = csr.crow_indices().diff()
        K = int(counts.max())
        row['ell_K'] = K
        if not isinstance(M, spmv.EllMatrix) and m * K * 12 <= 8e9:
            data, cols = _csr_ell(csr)
            lens = em.row_lens(data, cols)
            log2g = em.lanes_log2(lens)
            row['ell_ms'] = event_ms(lambda: em.ell_matvec(data, cols, v, lens, log2g), 20)
            del data, cols, lens
        print('format ladder:', json.dumps(row), flush=True)
        out.append(row)
        del csr
    return out


def families_card_vs_cpu():
    """The three families at a small size in f64 with a polish, on the card
    and on the CPU, with no dense budget so the ladder picks ELL, BSR and
    DIA + BCOO as at full size: the same formats and statuses, ADMM
    iterations within 5% (the gap is reported), x within 1e-6 of ||x||.
    The Portfolio's CG stops at its 20-step cap in almost every solve, so a
    last-bit difference between cuSPARSE's sums and the CPU's, which on the
    card also differ from run to run, moves where each solve stops (1,525,
    1,675 and 1,725 ADMM iterations on the card in three runs, 1,725 on the
    CPU) and the two eps-1e-3 solutions part by up to the solver's
    tolerance.  There the card's operator products (A v and A' y) are held
    to the CPU's within 1e-12 of each row's sum of |a| |v|, each x to its
    f64 host termination test, and the iteration gap and x gap are
    reported."""
    from osqp_tpu_torch import OSQP

    rows = []
    for name, build in (('ell n=4096', lambda: ell_family(4096)),
                        ('bsr nsb=32', lambda: clustered_family(32, 32)),
                        ('portfolio n=2000 k=20', lambda: portfolio_family(2000, 20))):
        P, q, A, l, u = build()
        out = {}
        for dev in (DEV, 'cpu'):
            o = OSQP(device=dev, sparse=True, dense_budget_bytes=0)
            o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=True,
                    verbose=False)
            out[dev] = (o.solve(raise_error=False),
                        (o._solver._sparse_fmt_P, o._solver._sparse_fmt_A), o._solver._data.A)
        (g, fg, Ag), (w, fw, Aw) = out[DEV], out['cpu']
        sensitive = name.startswith('portfolio')
        gap = abs(g.info.iter - w.info.iter) / max(w.info.iter, 1)
        dx = float(np.abs(g.x - w.x).max())
        row = dict(family=name, formats=list(fg), status_card=g.info.status,
                   status_cpu=w.info.status, iter_card=g.info.iter, iter_cpu=w.info.iter,
                   iter_gap=gap, cg_card=g.info.cg_iters, cg_cpu=w.info.cg_iters,
                   status_polish_card=g.info.status_polish,
                   status_polish_cpu=w.info.status_polish, x_diff=dx,
                   x_inf=float(np.abs(w.x).max()))
        if sensitive:
            row['residual_over_bound'] = [sparse_residual_check(P, A, l, u, q, r.x, r.y, EPS,
                                                                hold=False) for r in (g, w)]
            dense = Aw.todense()
            rng = np.random.default_rng(9)
            errs = []
            for Mg, Mw, S in ((Ag, Aw, dense), (Ag.T, Aw.T, dense.T)):
                x = torch.as_tensor(rng.standard_normal(S.shape[1]), dtype=torch.float64)
                diff = ((Mg @ x.to(DEV)).cpu() - Mw @ x).abs()
                errs.append(float((diff / (S.abs() @ x.abs()).clamp(min=1e-300)).max()))
            row['operator_rel_err'] = errs
        print('card vs cpu:', json.dumps(row), flush=True)
        if fg != fw or g.info.status != w.info.status or g.info.status != 'solved':
            raise AssertionError(f'{name}: card {fg} {g.info.status} vs cpu {fw} '
                                 f'{w.info.status}')
        if sensitive:
            for r in (g, w):
                sparse_residual_check(P, A, l, u, q, r.x, r.y, EPS)
            if max(row['operator_rel_err']) > 1e-12:
                raise AssertionError(f'{name}: the card\'s products differ from the CPU\'s: {row}')
        elif gap > 0.05 or dx > 1e-6 * max(row['x_inf'], 1e-300):
            raise AssertionError(f'{name}: iterations or x apart: {row}')
        rows.append(row)
    return rows


def derivative_problem(n, m, equalities=0, loose=0, seed=0):
    """tests/test_derivative.py::get_prob (numpy's global generator)."""
    import scipy.sparse as sparse

    np.random.seed(seed)
    L = np.random.randn(n, n - 1)
    P = sparse.csc_matrix(L.dot(L.T) + 0.1 * sparse.eye(n))
    x_0 = np.random.randn(n)
    s_0 = np.random.rand(m)
    A = sparse.csc_matrix(np.random.randn(m, n))
    u = A.dot(x_0) + s_0
    l = A.dot(x_0) - s_0
    u[:equalities] = l[:equalities]
    l[equalities:equalities + loose] = -1e30
    return P, np.random.randn(n), A, l, u


def derivatives_card_vs_cpu():
    """The derivative API on the card (float64 on the solver's device) after
    a solve on the card, against ``solver.derivatives`` on the CPU from the
    same x and y: adjoint (dP, dA, dq, dl, du) and forward (dx, dyl, dyu)
    within 1e-9 of each output's largest entry.  tests/test_derivative.py's
    problems and a dense random QP at n = 2000, m = 3000, whose API seconds
    are recorded."""
    from osqp_tpu_torch import OSQP
    from osqp_tpu_torch.solver import derivatives as der

    rows = []
    for name, prob, eps in (
            ('get_prob n=10 m=3', derivative_problem(10, 3, seed=4), 1e-9),
            ('get_prob n=100 m=120 eq=20 loose=20',
             derivative_problem(100, 120, 20, 20, seed=12), 1e-9),
            ('random n=2000 m=3000', random_sparse_qp(2000, 3000, 0.002, seed=0), 1e-6)):
        P, q, A, l, u = prob
        m, n = A.shape
        o = OSQP(device=DEV)
        o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=eps, eps_rel=eps, max_iter=200000,
                verbose=False)
        r = o.solve(raise_error=True)
        rng = np.random.default_rng(5)
        dx, dy = rng.standard_normal(n), rng.standard_normal(m)
        dq, du = rng.standard_normal(n), rng.standard_normal(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.adjoint_derivative_compute(dx=dx, dy=dy)
        dP, dA = o.adjoint_derivative_get_mat(as_dense=True, dP_as_triu=False)
        got = dict(zip(('dq', 'dl', 'du'), o.adjoint_derivative_get_vec()), dP=dP, dA=dA)
        adj_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd = o.forward_derivative(dq=dq, du=du)
        fwd_s = time.perf_counter() - t0
        want = der.adjoint_derivative(P, q, A, l, u, r.x, r.y, dx, dy, device='cpu')
        want_fwd = der.forward_derivative(P, q, A, l, u, r.x, r.y, dq=dq, du=du, device='cpu')
        errs = {}
        for k, g, w in [(k, got[k], want[k]) for k in want] + list(
                zip(('dx', 'dyl', 'dyu'), fwd, want_fwd)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-300)
            errs[k] = float(np.abs(g - w).max(initial=0.0)) / scale
        worst = max(errs.values())
        row = dict(problem=name, n=n, m=m, admm_iters=r.info.iter,
                   active=int(np.count_nonzero(got['dl']) + np.count_nonzero(got['du'])),
                   adjoint_s=adj_s, forward_s=fwd_s, max_rel_err=worst, rel_err=errs)
        print('derivatives card vs cpu:', json.dumps(row), flush=True)
        if not worst <= 1e-9:
            raise AssertionError(f'{name}: derivatives card vs cpu {worst} > 1e-9')
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# 10. codegen and export
# ---------------------------------------------------------------------------


class Exports:
    """Phase 10's exported programs.  ``run`` exports a model right after its
    setup, before its first solve (``codegen.driver.export_aot``, a
    ``torch.export`` program whose sparse products are the ``ops.library``
    operators), and runs the program once cold, with every kernel's launch
    count set to 0 just before the exported call and read just after; the
    counts are then restored, so the path's own counts stay its own.
    ``check`` holds that run to the path's live cold solve of the same model:
    the same status and iterations (and CG steps in sparse mode), x passing
    its f64 host termination test.  ``seconds`` sums the phase's wall time."""

    def __init__(self):
        self.runs = {}
        self.seconds = 0.0

    def run(self, name, o, prob, kernel, round_trip=False):
        import os
        import tempfile

        from osqp_tpu_torch.codegen.driver import AotSolve, export_aot

        t_phase = time.perf_counter()
        P, q, A, l, u = prob
        counters = _launch_counters()
        saved = {k: mod.launches for k, mod in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compiled = export_aot(o)
        export_s = time.perf_counter() - t0
        for mod in counters.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = compiled.solve(q, l, u)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: mod.launches for k, mod in counters.items()}
        if kernel and launches[kernel] <= 0:
            raise AssertionError(f'export {name}: the {kernel} kernel never launched')
        rec = dict(dtype=str(o._solver._dtype).replace('torch.', ''), n=int(o.n), m=int(o.m),
                   kernel=kernel, export_s=export_s, exported_wall_s=wall_s, launches=launches,
                   result=res, prob=prob)
        if round_trip:
            # torch.export.save / load on the card: the reloaded program
            # must give the same outputs bit for bit
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, 'solve.pt2')
                torch.export.save(compiled.program, path)
                rec['saved_mb'] = os.path.getsize(path) / 1e6
                loaded = AotSolve(torch.export.load(path), compiled.dtype, compiled.device)
            again = loaded.solve(q, l, u)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(again, res)):
                raise AssertionError(f'export {name}: the reloaded program gives other outputs')
            rec['round_trip_s'] = time.perf_counter() - t0
            rec['round_trip_bit_identical'] = True
        for k, mod in counters.items():
            mod.launches = saved[k]
        self.runs[name] = rec
        self.seconds += time.perf_counter() - t_phase

    def check(self, name, live, live_wall_s, sparse=True):
        t_phase = time.perf_counter()
        rec = self.runs[name]
        r = rec.pop('result')
        P, q, A, l, u = rec.pop('prob')
        got = dict(status=int(r.status), iters=int(r.iters), cg_steps=int(r.cg_iters))
        want = dict(status=live.info.status_val, iters=live.info.iter,
                    cg_steps=live.info.cg_iters)
        if not sparse:
            del got['cg_steps'], want['cg_steps']
        if got != want:
            raise AssertionError(f'export {name}: exported {got}, live {want}')
        x = r.x.cpu().numpy().astype(np.float64)
        y = r.y.cpu().numpy().astype(np.float64)
        rec.update(status=live.info.status, iters=int(r.iters), cg_steps=int(r.cg_iters),
                   rho_updates=int(r.rho_updates), live_cold_wall_s=live_wall_s,
                   max_abs_dx_vs_live=float(np.abs(x - live.x).max()),
                   residual_over_bound=sparse_residual_check(P, A, l, u, q, x, y, EPS))
        print(f'export {name}:', json.dumps(rec), flush=True)
        self.seconds += time.perf_counter() - t_phase
        return rec


def dense_export_case(exports, n=2000, m=3000, density=0.002):
    """The dense direct path (f64, Cholesky, refactored inside the exported
    loop at each rho update) on phase 7's random sparse QP at n = 2000,
    m = 3000 and the density at which its cold solve updates rho (once, at
    eps 1e-3; 0.01 solves with none): export right after setup, one
    exported cold solve against the live cold solve."""
    from osqp_tpu_torch import OSQP

    t_phase = time.perf_counter()
    prob = random_sparse_qp(n, m, density, seed=0)
    P, q, A, l, u = prob
    o = OSQP(device=DEV, sparse=False)
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, polishing=False, verbose=False)
    exports.seconds += time.perf_counter() - t_phase
    exports.run('dense direct (Cholesky)', o, prob, None)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = o.solve(raise_error=False)
    wall = time.perf_counter() - t0
    exports.seconds += time.perf_counter() - t_phase
    rec = exports.check('dense direct (Cholesky)', live, wall, sparse=False)
    if rec['rho_updates'] < 1:
        raise AssertionError('dense export: no rho update, so no refactorization in the loop')
    return rec


def codegen_problems():
    """tests/test_codegen.py's vectors problem (eps 1e-8) and its n = 2000
    banded QP of the sparse emitter, the latter at eps 1e-7 so that the two
    solvers' answers (the emitted Jacobi-PCG ADMM and the port's) lie well
    within 1e-4 of each other."""
    import scipy.sparse as sparse

    P = sparse.diags([11.0, 0.0], format='csc')
    A = sparse.csc_matrix([[-1, 0], [0, -1], [-1, -3], [2, 5], [3, 4]], dtype=float)
    vec = ((P, np.array([3.0, 4.0]), A, -np.inf * np.ones(5),
            np.array([0.0, 0.0, -15.0, 100.0, 80.0])),
           dict(eps_abs=1e-8, eps_rel=1e-8, rho=0.01, alpha=1.6, max_iter=10000), False, {})
    n = 2000
    rng = np.random.default_rng(0)
    P = sparse.diags([np.full(n, 2.0), np.full(n - 1, -0.7), np.full(n - 1, -0.7)],
                     [0, 1, -1]).tocsc()
    A = (sparse.eye(n) + sparse.diags([np.full(n - 2, 0.4)], [2], shape=(n, n))).tocsc()
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    s0 = rng.random(n) + 0.1
    u = A @ x0 + s0
    banded = ((P, q, A, u - 2 * s0, u), dict(eps_abs=1e-7, eps_rel=1e-7), True,
              dict(parameters='matrices', embedded_algebra='sparse'))
    return {'vectors (dense emitter)': vec, 'banded n=2000 (sparse emitter)': banded}


def embedded_solve(folder, n, m, sparse_mode):
    """Compile the emitted workspace.c and emosqp_solver.c with the system C
    compiler into a shared library, call ``osqp_solve`` through ctypes and
    read the workspace: ``(rc, status, iters, x, y, compile_s)``."""
    import ctypes

    t0 = time.perf_counter()
    lib_path = Path(folder) / 'libemosqp.so'
    proc = subprocess.run(['cc', '-O2', '-shared', '-fPIC', '-o', str(lib_path), 'workspace.c',
                           'emosqp_solver.c', '-lm'], cwd=folder, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f'cc failed on the emitted C:\n{proc.stdout}\n{proc.stderr}')
    compile_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    F, m1 = ctypes.c_double, max(m, 1)
    fields = [('x', F * n), ('z', F * m1), ('y', F * m1), ('delta_x', F * n),
              ('delta_y', F * m1)] + ([('xt', F * n)] if sparse_mode else []) + [
        ('pri_res', F), ('dua_res', F), ('run_time', F), ('status_val', ctypes.c_int),
        ('iter', ctypes.c_int)]
    work_t = type('Workspace', (ctypes.Structure,), {'_fields_': fields})
    lib.osqp_solve.restype = ctypes.c_int
    lib.osqp_solve.argtypes = []
    rc = lib.osqp_solve()
    work = work_t.in_dll(lib, 'work')
    x = np.ctypeslib.as_array((F * n).in_dll(lib, 'sol_x')).copy()
    y = np.ctypeslib.as_array((F * m1).in_dll(lib, 'sol_y'))[:m].copy()
    return rc, work.status_val, work.iter, x, y, compile_s


def emitter_case(name, prob, opts, sparse, gen_kw):
    """``OSQP.codegen`` from a model on the card; the emitted C compiled and
    solved through ctypes must end solved with x within 1e-4 of the live
    solve's."""
    import tempfile

    from osqp_tpu_torch import OSQP

    P, q, A, l, u = prob
    o = OSQP(device=DEV, sparse=sparse)
    o.setup(P=P, q=q, A=A, l=l, u=u, verbose=False, **opts)
    live = o.solve(raise_error=False)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        o.codegen(tmp, extension_name=None, force_rewrite=True, **gen_kw)
        gen_s = time.perf_counter() - t0
        ws_mb = (Path(tmp) / 'workspace.c').stat().st_size / 1e6
        rc, status, iters, x, y, compile_s = embedded_solve(
            tmp, o.n, o.m, gen_kw.get('embedded_algebra') == 'sparse')
    dx = float(np.abs(x - live.x).max())
    if rc != 0 or status != 1 or live.info.status != 'solved' or not dx <= 1e-4:
        raise AssertionError(f'emitted C ({name}): rc {rc}, status {status}, live '
                             f'{live.info.status}, max |x - x_live| {dx}')
    rec = dict(n=int(o.n), m=int(o.m), generate_s=gen_s, workspace_c_mb=ws_mb,
               compile_s=compile_s, status=status, iters=iters, live_iters=live.info.iter,
               max_abs_dx_vs_live=dx)
    print(f'emitted C {name}:', json.dumps(rec), flush=True)
    return rec


def codegen_phase(exports):
    """Phase 10's last part: the dense export case and the C emitter."""
    dense_export_case(exports)
    t0 = time.perf_counter()
    for name, (prob, opts, sparse, gen_kw) in codegen_problems().items():
        emitter_case(name, prob, opts, sparse, gen_kw)
    exports.seconds += time.perf_counter() - t0
    summary = dict(phase_s=exports.seconds, cases={
        name: dict(export_s=r['export_s'], exported_wall_s=r['exported_wall_s'],
                   live_cold_wall_s=r['live_cold_wall_s'], iters=r['iters'],
                   launches={k: v for k, v in r['launches'].items() if v})
        for name, r in exports.runs.items()})
    print('codegen and export:', json.dumps(summary), flush=True)
    return summary



# ---------------------------------------------------------------------------
# 11. the multi-device package: a mesh of shards on the card(s)
# ---------------------------------------------------------------------------

PAR_J = 4            # shards of the huge-QP meshes
PAR_CG_CAP = 1000    # cg_max_iter of the card runs (the default is max(2n, 100))
PAR_CHECK_N = 4096   # card against CPU
DPMP = (4096, 32, 48)
DPMP_CHECK_B = 8


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _solve_row(res, wall_s):
    return dict(status=res.status, iters=res.iters, rho_updates=res.rho_updates,
                cg_steps=res.cg_iters, cg_cap_hits=res.cg_cap_hits, host_syncs=res.host_syncs,
                wall_s=wall_s)


def halo_k2_rows(card, mesh, data):
    """K2 on shard 1's halo window of the banded path (an interior shard:
    both halos are a neighbour's), at the path's own (L + 2W,) window and
    shifted offsets, on shard 1's device: P's, A's and A''s bands in f32 and
    f64 bit for bit against the plain version; for P's (the widest) the
    kernel's device time with the L2 warm (back to back, as the path calls
    it) and with the L2 flushed (the time the byte bound applies to), the
    plain version's and cuSPARSE's, one row a dtype."""
    import scipy.sparse as sparse
    from osqp_tpu_torch.ops import dia_matvec as dm

    f32_peak, f64_peak, mem_peak, _ = peaks(card)
    J, L = data.q.shape
    W = max(1, max(abs(o) for offs in (data.offsets_p, data.offsets_a, data.offsets_at)
                   for o in offs))
    dev = mesh.device_list[1]
    v = torch.as_tensor(np.random.default_rng(5).standard_normal((J, L)), device=DEV)
    # writing 64 MB evicts the 50 MB L2 before each cold call, as in phase 5
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for dtype in (torch.float32, torch.float64):
        wins = mesh.halo_window(mesh.split(v.to(dtype), ('mp',)).map(lambda t: t[0]), W)
        for label, bands_all, offsets in (('P', data.p_bands, data.offsets_p),
                                          ('A', data.a_bands, data.offsets_a),
                                          ("A'", data.at_bands, data.offsets_at)):
            bands = bands_all[1].to(dev, dtype).contiguous()
            off = torch.tensor([W + o for o in offsets], dtype=torch.int32, device=dev)
            win = wins[1]
            got = dm.dia_matvec(bands, off, win)
            want = dm.dia_matvec_plain(bands, off, win)
            if not torch.equal(got, want):
                raise AssertionError(f'K2 on the halo window ({label}, {dtype}) differs from its '
                                     f'plain version by {float((got - want).abs().max())}')
            if label != 'P':
                continue
            kern = lambda: dm.dia_matvec(bands, off, win)  # noqa: E731
            b = bands.cpu().numpy()
            r = np.arange(L)
            S = sparse.coo_matrix((b.reshape(-1), (np.tile(r, len(offsets)), np.concatenate(
                [r + W + o for o in offsets]))), shape=(L, L + 2 * W))
            csr = _csr(S, dtype, dev)
            item = torch.empty((), dtype=dtype).element_size()
            bound, by = dia_bound_ms(len(offsets), L, L + 2 * W, item,
                                     f32_peak if dtype == torch.float32 else f64_peak, mem_peak)
            ms = device_ms(kern, 50, name='dia_matvec_kernel')
            cold_ms = device_ms(kern, 20, name='dia_matvec_kernel', flush=flush.zero_)
            row = dict(case=f'{label} on the halo window', dtype=str(dtype).replace('torch.', ''),
                       device=str(dev), D=len(offsets), m_out=L, n_in=L + 2 * W, W=W,
                       bit_identical=['P', 'A', "A'"],
                       max_abs_err=0.0, ms=ms, cold_l2_ms=cold_ms,
                       plain_ms=device_ms(lambda: dm.dia_matvec_plain(bands, off, win), 50),
                       library_ms=device_ms(lambda: csr @ win, 50), bound_ms=bound, bound_by=by,
                       bound_share_cold_l2=bound / cold_ms)
            print('K2 on the banded halo window:', json.dumps(row), flush=True)
            rows.append(row)
    return rows


def parallel_card_vs_cpu():
    """banded and bigqp at n = 4096 on J = 4 shards (eps 1e-4), and
    dp_mp_solve at (2, 2) with B = 8 (eps 1e-5), f64, on the card against
    the CPU: the same statuses and iterations (rho updates too), x within
    1e-9."""
    from osqp_tpu_torch import parallel as par

    out = {}
    P, q, A, l, u = banded_qp(PAR_CHECK_N, seed=1)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, cg_max_iter=PAR_CG_CAP)
    for name, setup, solve in (('banded', par.banded_qp_setup, par.banded_qp_solve),
                               ('bigqp', par.big_qp_setup, par.big_qp_solve)):
        got, want = (solve(par.make_mesh((PAR_J,), ('mp',), device=dev),
                           setup(P, q, A, l, u, PAR_J, device=dev), **kw)
                     for dev in (DEV, 'cpu'))
        dx = float((got.x.cpu() - want.x).abs().max())
        if (got.status, got.iters, got.rho_updates) != (want.status, want.iters,
                                                        want.rho_updates) or not dx <= 1e-9:
            raise AssertionError(f'{name} card vs cpu: {got.status, got.iters, got.rho_updates} '
                                 f'vs {want.status, want.iters, want.rho_updates}, dx {dx}')
        out[name] = dict(n=PAR_CHECK_N, status=got.status, iters=got.iters,
                         cg_card=got.cg_iters, cg_cpu=want.cg_iters, x_diff=dx)
    P, q, A, l, u = build_vmap_problems(DPMP_CHECK_B, DPMP[1], DPMP[2], seed=0)
    got, want = (par.dp_mp_solve(par.make_mesh((2, 2), ('dp', 'mp'), device=dev), P, q, A, l, u,
                                 eps_abs=1e-5, eps_rel=1e-5) for dev in (DEV, 'cpu'))
    dx = float((got.x.cpu() - want.x).abs().max())
    for name in ('status', 'iters', 'rho_updates'):
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
            raise AssertionError(f'dp_mp card vs cpu: {name} {getattr(got, name).tolist()} vs '
                                 f'{getattr(want, name).tolist()}')
    if not dx <= 1e-9:
        raise AssertionError(f'dp_mp card vs cpu: x differs by {dx}')
    out['dp_mp'] = dict(B=DPMP_CHECK_B, iters=got.iters.tolist(), x_diff=dx)
    return out


def dpmp_path():
    """dp_mp_solve at full size on a (2, 2) mesh: phase 4b's per-instance
    plant family (build_vmap_problems, seed 0) at B = 4096, n = 32, m = 48,
    f64, eps 1e-3.  Every instance solved, the f64 host check of every
    instance, 64 instances near the port's f64 CPU optimum."""
    from types import SimpleNamespace

    from osqp_tpu_torch import parallel as par

    B, n, m = DPMP
    P, q, A, l, u = build_vmap_problems(B, n, m, seed=0)
    mesh = par.make_mesh((2, 2), ('dp', 'mp'))
    res, wall = _timed(lambda: par.dp_mp_solve(mesh, P, q, A, l, u, eps_abs=EPS, eps_rel=EPS))
    status = res.status.cpu().numpy()
    if not (status == 1).all():
        raise AssertionError(f'dp_mp: {int((status != 1).sum())} of {B} instances not solved')
    r = SimpleNamespace(x=res.x.cpu().numpy(), y=res.y.cpu().numpy(),
                        info=SimpleNamespace(status_val=status))
    run = dict(results=[r], P=P, A=A, l=l, u=u, q=q, kw=dict(eps_abs=EPS), noise=None)
    iters = res.iters.cpu().numpy()
    # the first two epochs again under the profiler
    _, prof_ms, kernels = _profiled(lambda: par.dp_mp_solve(mesh, P, q, A, l, u, eps_abs=EPS,
                                                             eps_rel=EPS, max_iter=50))
    summary = dict(B=B, n=n, m=m, dtype='float64', eps=EPS, mesh=mesh.shape, wall_s=wall,
                   profile_50_iterations=_profile_numbers(prof_ms, kernels),
                   solves_per_s=B / wall, mean_iters=float(iters.mean()),
                   max_iters=int(iters.max()), rho_updates=int(res.rho_updates.sum()),
                   host_syncs=res.host_syncs, residual_over_bound=residual_check(run),
                   x_off_f64_optimum=reference_check(run))
    return summary, _dpmp_fields(res)


def _dpmp_fields(res):
    """What phase 11b compares of a dp_mp_solve result, on the host."""
    return {k: getattr(res, k).cpu() for k in ('x', 'y', 'status', 'iters', 'rho_updates')}


def parallel_phase(card):
    """Phase 11.  Returns (summary, K2 rows on the halo window, K2's launches
    on the distributed banded path, the results phase 11b compares with)."""
    from osqp_tpu_torch import parallel as par
    from osqp_tpu_torch.ops import dia_matvec as dm

    t_phase = time.perf_counter()
    mesh = par.make_mesh((PAR_J,), ('mp',))
    devs = [str(d) for d in mesh.device_list]
    print('mesh:', json.dumps(dict(shape=mesh.shape, devices=devs, distinct=len(set(devs)))),
          flush=True)
    n = SPARSE_N
    P, q, A, l, u = banded_qp(n, seed=0)
    kw = dict(eps_abs=EPS, eps_rel=EPS, cg_max_iter=PAR_CG_CAP)

    # banded: setup, a cold solve and a 3-step warm rollout (phase 6's
    # q * 1.01^k) from the cold solve's scaled iterates, K2 counted around
    # the solves
    bd, banded_setup_s = _timed(lambda: par.banded_qp_setup(P, q, A, l, u, PAR_J))
    dm.launches = 0
    cold, cold_s = _timed(lambda: par.banded_qp_solve(mesh, bd, **kw))
    q_seq = np.stack([q * 1.01 ** k for k in range(1, SPARSE_WARM + 1)])
    Dinv, Einv = bd.Dinv.reshape(-1)[:n], bd.Einv.reshape(-1)[:n]
    roll, roll_s = _timed(lambda: par.banded_mpc_rollout(
        mesh, bd, q_seq, x0=cold.x * Dinv, z0=cold.z, y0=cold.y * bd.c * Einv, **kw))
    banded_launches = dm.launches
    if banded_launches <= 0:
        raise AssertionError('the distributed banded path never launched the dia_matvec kernel')
    statuses = [cold.status] + roll.status.tolist()
    if any(st != 1 for st in statuses):
        raise AssertionError(f'banded path statuses {statuses}')
    ratios = [sparse_residual_check(P, A, l, u, qk, x.cpu().numpy(), y.cpu().numpy(), EPS)
              for qk, x, y in zip([q, *q_seq], [cold.x, *roll.x], [cold.y, *roll.y])]
    banded = dict(n=n, J=PAR_J, L=bd.L, dtype='float64', eps=EPS, setup_s=banded_setup_s,
                  cold=_solve_row(cold, cold_s), rollout_s=roll_s,
                  rollout_iters=roll.iters.tolist(), rollout_cg_steps=list(roll.cg_iters),
                  rollout_host_syncs=list(roll.host_syncs), k2_launches=banded_launches,
                  residual_over_bound=ratios)
    print('banded (J = 4, n = 2^20):', json.dumps(banded), flush=True)

    # bigqp: the same problem, a cold solve: banded's iterations, x within 1e-8
    gd, big_setup_s = _timed(lambda: par.big_qp_setup(P, q, A, l, u, PAR_J))
    big, big_s = _timed(lambda: par.big_qp_solve(mesh, gd, **kw))
    if big.status != 1:
        raise AssertionError(f'bigqp status {big.status}')
    dx = float((big.x - cold.x).abs().max())
    tol = 1e-8 + 1e-8 * float(cold.x.abs().max())
    if big.iters != cold.iters or not dx <= tol:
        raise AssertionError(f'bigqp {big.iters} iterations vs banded {cold.iters}, x differs by '
                             f'{dx} (tolerance {tol})')
    # a second cold solve: are two one-process runs on the card (cuSPARSE)
    # bit-identical?  Phase 11b holds the process mesh to bits if so
    again = par.big_qp_solve(mesh, gd, **kw)
    deterministic = torch.equal(again.x, big.x) and torch.equal(again.y, big.y)
    del again
    bigqp = dict(n=n, J=PAR_J, setup_s=big_setup_s, cold=_solve_row(big, big_s),
                 x_diff_vs_banded=dx, two_runs_bit_identical=deterministic,
                 residual_over_bound=sparse_residual_check(
                     P, A, l, u, q, big.x.cpu().numpy(), big.y.cpu().numpy(), EPS))
    print('bigqp (J = 4, n = 2^20):', json.dumps(bigqp), flush=True)
    # what phase 11b holds the process mesh to, on the host
    ref = dict(banded=dict(cold=banded['cold'], rollout_s=roll_s,
                           rollout_iters=banded['rollout_iters'],
                           rollout_cg_steps=banded['rollout_cg_steps'],
                           rollout_host_syncs=banded['rollout_host_syncs'],
                           x=[cold.x.cpu(), *roll.x.cpu()], y=[cold.y.cpu(), *roll.y.cpu()]),
               bigqp=dict(cold=bigqp['cold'], deterministic=deterministic, x=big.x.cpu(),
                          y=big.y.cpu()))

    # one warm solve of each under the profiler: banded from the rollout's
    # carries on its last q, bigqp from its own solution
    def banded_warm():
        warm = par.banded_qp_update_vec(bd, q=q_seq[-1])
        return par.banded_qp_solve(mesh, warm, x0=roll.x_carry, z0=roll.z_carry,
                                   y0=roll.y_carry, **kw)

    def bigqp_warm():
        return par.big_qp_solve(mesh, gd, x0=big.x * gd.Dinv, z0=big.z,
                                y0=big.y * gd.c * gd.Einv.reshape(-1)[:n], **kw)

    for name, fn in (('banded', banded_warm), ('bigqp', bigqp_warm)):
        res, wall_ms, kernels = _profiled(fn)
        prof = dict(iters=res.iters, cg_steps=res.cg_iters, host_syncs=res.host_syncs,
                    wall_ms_per_cg_step=wall_ms / max(res.cg_iters, 1),
                    **_profile_numbers(wall_ms, kernels))
        print(f'{name} warm solve profile:', json.dumps(prof), flush=True)
        (banded if name == 'banded' else bigqp)['warm_profile'] = prof
    del gd, big

    k2_rows = halo_k2_rows(card, mesh, bd)
    del bd, roll
    torch.cuda.empty_cache()
    versus = parallel_card_vs_cpu()
    print('parallel card vs cpu:', json.dumps(versus), flush=True)
    dpmp, ref['dp_mp'] = dpmp_path()
    ref['dp_mp'].update(wall_s=dpmp['wall_s'], host_syncs=dpmp['host_syncs'])
    print('dp_mp (2 x 2, B = 4096):', json.dumps(dpmp), flush=True)
    summary = dict(phase_s=time.perf_counter() - t_phase, devices=devs,
                   distinct_devices=len(set(devs)), banded=banded, bigqp=bigqp,
                   card_vs_cpu=versus, dp_mp=dpmp)
    print(f'multi-device phase: {summary["phase_s"]:.1f} s', flush=True)
    return summary, k2_rows, banded_launches, ref

# ---------------------------------------------------------------------------
# 11b. the mesh over processes: children of this script, over torch.distributed
# ---------------------------------------------------------------------------

PROCS_GLOO = 2          # gloo processes sharing cuda:0, PAR_J / 2 shards each
PROCS_NCCL_N = 1 << 16  # the banded family's size for one NCCL process a card
PROCS_WALL_S = 300.0    # a child still running past this is killed and fails the run
PROCS_GROUP_TIMEOUT_S = 120.0


def mesh_worker(backend, rank, world, init, out_dir):
    """One child of phase 11b: joins the group, runs its paths, writes what
    phase 11b compares to ``out_dir/rank<rank>.pt``.  A small solve on a
    one-process mesh first takes the process's first-use costs (CUDA
    context, cuBLAS, K2's library) out of the timed solves."""
    from osqp_tpu_torch import parallel as par

    torch.set_num_threads(1)
    par.initialize(backend, init_method=init, rank=rank, world_size=world,
                   timeout_s=PROCS_GROUP_TIMEOUT_S)
    try:
        own = torch.device('cuda', torch.cuda.current_device())  # LOCAL_RANK's under NCCL
        P, q, A, l, u = banded_qp(4096, seed=0)
        par.banded_qp_solve(par.make_mesh((2,), ('mp',), device=own),
                            par.banded_qp_setup(P, q, A, l, u, 2, device=own), max_iter=25)
        out = (_procs_gloo_paths if backend == 'gloo' else _procs_nccl_path)()
        out['world'] = par.process_count()
    finally:
        par.shutdown()
    torch.save(out, Path(out_dir) / f'rank{rank}.pt')
    return 0


def _procs_gloo_paths():
    """Phase 11's paths on a mesh of PAR_J shards over the gloo processes,
    this process's on cuda:0: banded (setup, cold, 3-step rollout, K2
    counted), bigqp (setup, cold) and dp_mp_solve on (2, 2), dp across the
    processes, at phase 11's sizes and settings."""
    from osqp_tpu_torch import parallel as par
    from osqp_tpu_torch.ops import dia_matvec as dm

    dev = 'cuda:0'
    n = SPARSE_N
    P, q, A, l, u = banded_qp(n, seed=0)
    kw = dict(eps_abs=EPS, eps_rel=EPS, cg_max_iter=PAR_CG_CAP)
    mesh = par.make_mesh((PAR_J,), ('mp',), device=dev, group='world')
    bd, setup_s = _timed(lambda: par.banded_qp_setup(P, q, A, l, u, PAR_J, device=dev))
    dm.launches = 0
    cold, cold_s = _timed(lambda: par.banded_qp_solve(mesh, bd, **kw))
    q_seq = np.stack([q * 1.01 ** k for k in range(1, SPARSE_WARM + 1)])
    Dinv, Einv = bd.Dinv.reshape(-1)[:n], bd.Einv.reshape(-1)[:n]
    roll, roll_s = _timed(lambda: par.banded_mpc_rollout(
        mesh, bd, q_seq, x0=cold.x * Dinv, z0=cold.z, y0=cold.y * bd.c * Einv, **kw))
    out = dict(banded=dict(
        setup_s=setup_s, cold=_solve_row(cold, cold_s), rollout_s=roll_s,
        rollout_status=roll.status.tolist(), rollout_iters=roll.iters.tolist(),
        rollout_cg_steps=list(roll.cg_iters), rollout_host_syncs=list(roll.host_syncs),
        k2_launches=dm.launches, x=[cold.x.cpu(), *roll.x.cpu()],
        y=[cold.y.cpu(), *roll.y.cpu()]))
    del bd, cold, roll
    gd, setup_s = _timed(lambda: par.big_qp_setup(P, q, A, l, u, PAR_J, device=dev))
    big, big_s = _timed(lambda: par.big_qp_solve(mesh, gd, **kw))
    out['bigqp'] = dict(setup_s=setup_s, cold=_solve_row(big, big_s), x=big.x.cpu(),
                        y=big.y.cpu())
    del gd, big
    torch.cuda.empty_cache()
    B, nb, m = DPMP
    batch = build_vmap_problems(B, nb, m, seed=0)
    dmesh = par.make_mesh((2, 2), ('dp', 'mp'), device=dev, group='world')
    res, wall = _timed(lambda: par.dp_mp_solve(dmesh, *batch, eps_abs=EPS, eps_rel=EPS))
    out['dp_mp'] = dict(_dpmp_fields(res), wall_s=wall, host_syncs=res.host_syncs)
    return out


def _procs_nccl_path():
    """The banded family at n = PROCS_NCCL_N on two shards a process, each
    process's on its card (LOCAL_RANK's): a cold solve, K2 counted."""
    from osqp_tpu_torch import parallel as par
    from osqp_tpu_torch.ops import dia_matvec as dm

    shards = 2 * par.process_count()
    P, q, A, l, u = banded_qp(PROCS_NCCL_N, seed=0)
    mesh = par.make_mesh((shards,), ('mp',), group='world')
    data = par.banded_qp_setup(P, q, A, l, u, shards)
    dm.launches = 0
    res, wall = _timed(lambda: par.banded_qp_solve(mesh, data, eps_abs=EPS, eps_rel=EPS,
                                                   cg_max_iter=PAR_CG_CAP))
    return dict(banded=dict(_solve_row(res, wall), k2_launches=dm.launches,
                            device=str(mesh.device_list[0]), x=res.x.cpu()))


def run_children(cmd, world, logdir, wall_s, label, env=None):
    """Run ``cmd --rank r`` for every rank r < ``world`` on this host, each
    child's output in ``logdir/rank<r>.log``, and wait for all: a child
    that fails, or the wall limit passing, kills every child still running
    and raises with the end of each log."""
    logs = [Path(logdir) / f'rank{r}.log' for r in range(world)]
    env = dict(os.environ, **(env or {}))

    def tails():
        return ''.join(f'\n--- {log.name} ---\n{log.read_text()[-4000:]}' for log in logs
                       if log.exists())

    procs = []
    try:
        for r in range(world):
            with open(logs[r], 'w') as log:
                procs.append(subprocess.Popen([*cmd, '--rank', str(r)], stdout=log,
                                              stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + wall_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f'{label}: worker {bad[0]} exited with {codes[bad[0]]}'
                                   + tails())
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f'{label}: workers still running after {wall_s} s' + tails())
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launch_mesh_workers(backend, world, workdir):
    """``world`` children running ``mesh_worker`` over a FileStore in
    ``workdir``; returns each rank's results."""
    workdir.mkdir(parents=True, exist_ok=True)
    for f in workdir.iterdir():
        f.unlink()
    cmd = [sys.executable, str(Path(__file__).resolve()), '--mesh-worker', backend,
           '--world', str(world), '--init', f'file://{workdir / "store"}', '--out', str(workdir)]
    run_children(cmd, world, workdir, PROCS_WALL_S, f'{backend} mesh')
    return [torch.load(workdir / f'rank{r}.pt', weights_only=True) for r in range(world)]


def _counts(row):
    return {k: row[k] for k in ('status', 'iters', 'rho_updates', 'cg_steps', 'cg_cap_hits',
                                'host_syncs')}


def _per_step(row):
    """Wall, CG steps, host syncs and wall per CG step of one solve."""
    return dict(wall_s=row['wall_s'], cg_steps=row['cg_steps'], host_syncs=row['host_syncs'],
                wall_ms_per_cg_step=1e3 * row['wall_s'] / max(row['cg_steps'], 1))


def _bits_equal(got, want):
    return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
        g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))
        for g, w in zip(got, want)) and len(got) == len(want)


def procs_phase(card_line, ref):
    """Phase 11b.  Returns K2's launches in each process of each group."""
    from osqp_tpu_torch import parallel as par

    t_phase = time.perf_counter()
    work = ROOT / 'build' / 'mesh_procs'
    n = SPARSE_N
    P, q, A, l, u = banded_qp(n, seed=0)
    q_seq = [q * 1.01 ** k for k in range(1, SPARSE_WARM + 1)]
    transport = ('gloo: both processes on cuda:0, the bytes of every exchange through pinned '
                 'host memory (not NCCL)')
    gloo = launch_mesh_workers('gloo', PROCS_GLOO, work / 'gloo')
    rows = []
    for rank, out in enumerate(gloo):
        if out['world'] != PROCS_GLOO:
            raise AssertionError(f'gloo rank {rank}: a world of {out["world"]}')
        b, want = out['banded'], ref['banded']
        statuses = [b['cold']['status'], *b['rollout_status']]
        if any(st != 1 for st in statuses):
            raise AssertionError(f'gloo rank {rank}: banded statuses {statuses}')
        if b['k2_launches'] <= 0:
            raise AssertionError(f'gloo rank {rank}: the banded path never launched K2')
        same = (_counts(b['cold']) == _counts(want['cold'])
                and (b['rollout_iters'], b['rollout_cg_steps'], b['rollout_host_syncs'])
                == (want['rollout_iters'], want['rollout_cg_steps'], want['rollout_host_syncs']))
        if not same or not _bits_equal(b['x'] + b['y'], want['x'] + want['y']):
            raise AssertionError(f'gloo rank {rank}: banded differs from phase 11: counts '
                                 f'{_counts(b["cold"])} vs {_counts(want["cold"])}, rollout '
                                 f'{b["rollout_cg_steps"]} vs {want["rollout_cg_steps"]}')
        ratios = [sparse_residual_check(P, A, l, u, qk, x.numpy(), y.numpy(), EPS)
                  for qk, x, y in zip([q, *q_seq], b['x'], b['y'])] if rank == 0 else None
        g, gw = out['bigqp'], ref['bigqp']
        if _counts(g['cold']) != _counts(gw['cold']) or g['cold']['status'] != 1:
            raise AssertionError(f'gloo rank {rank}: bigqp counts {_counts(g["cold"])} vs '
                                 f'{_counts(gw["cold"])}')
        big_bits = _bits_equal([g['x'], g['y']], [gw['x'], gw['y']])
        big_dx = float((g['x'] - gw['x']).abs().max())
        if gw['deterministic'] and not big_bits:
            raise AssertionError(f'gloo rank {rank}: bigqp x differs by {big_dx} where two '
                                 'one-process runs are bit-identical')
        if not big_dx <= 1e-12 * float(gw['x'].abs().max()):
            raise AssertionError(f'gloo rank {rank}: bigqp x differs by {big_dx}')
        d, dw = out['dp_mp'], ref['dp_mp']
        if not (d['status'] == 1).all():
            raise AssertionError(f'gloo rank {rank}: dp_mp: {int((d["status"] != 1).sum())} '
                                 'instances not solved')
        keys = ('x', 'y', 'status', 'iters', 'rho_updates')
        if d['host_syncs'] != dw['host_syncs'] or not _bits_equal([d[k] for k in keys],
                                                                 [dw[k] for k in keys]):
            raise AssertionError(f'gloo rank {rank}: dp_mp differs from phase 11')
        rows.append(dict(
            rank=rank, k2_launches=b['k2_launches'],
            banded=dict(setup_s=b['setup_s'], cold=_per_step(b['cold']),
                        rollout_s=b['rollout_s'], rollout_cg_steps=b['rollout_cg_steps'],
                        rollout_ms_per_cg_step=1e3 * b['rollout_s'] / sum(b['rollout_cg_steps']),
                        counts_and_bits_equal_phase_11=True, residual_over_bound=ratios),
            bigqp=dict(setup_s=g['setup_s'], cold=_per_step(g['cold']),
                       rule='bits' if gw['deterministic'] else '1e-12 of ||x||, counts equal',
                       bit_identical=big_bits, x_diff=big_dx),
            dp_mp=dict(wall_s=d['wall_s'], solves_per_s=DPMP[0] / d['wall_s'],
                       host_syncs=d['host_syncs'], equal_phase_11_bits=True)))
    wb, wg = ref['banded'], ref['bigqp']
    line = dict(
        card=card_line, transport=transport, processes=PROCS_GLOO, shards=PAR_J, n=n,
        dtype='float64', eps=EPS, per_process=rows,
        phase_11_one_process=dict(
            banded=dict(cold=_per_step(wb['cold']), rollout_s=wb['rollout_s'],
                        rollout_cg_steps=wb['rollout_cg_steps'],
                        rollout_ms_per_cg_step=1e3 * wb['rollout_s'] / sum(
                            wb['rollout_cg_steps'])),
            bigqp=dict(cold=_per_step(wg['cold']), two_runs_bit_identical=wg['deterministic']),
            dp_mp=dict(wall_s=ref['dp_mp']['wall_s'],
                       solves_per_s=DPMP[0] / ref['dp_mp']['wall_s'],
                       host_syncs=ref['dp_mp']['host_syncs'])))
    print(f'mesh over processes ({transport}):', json.dumps(line), flush=True)

    # NCCL: one process a card, two shards each, against the one-process mesh
    world = torch.cuda.device_count()
    nccl = launch_mesh_workers('nccl', world, work / 'nccl')
    Pn, qn, An, ln, un = banded_qp(PROCS_NCCL_N, seed=0)
    mesh = par.make_mesh((2 * world,), ('mp',))
    want, wall = _timed(lambda: par.banded_qp_solve(
        mesh, par.banded_qp_setup(Pn, qn, An, ln, un, 2 * world), eps_abs=EPS, eps_rel=EPS,
        cg_max_iter=PAR_CG_CAP))
    want_row = _solve_row(want, wall)
    nrows = []
    for rank, out in enumerate(nccl):
        b = out['banded']
        if out['world'] != world or _counts(b) != _counts(want_row) or b['k2_launches'] <= 0:
            raise AssertionError(f'nccl rank {rank} (world {out["world"]}): counts '
                                 f'{_counts(b)} vs {_counts(want_row)}, K2 {b["k2_launches"]}')
        nrows.append(dict(rank=rank, device=b['device'], k2_launches=b['k2_launches'],
                          cold=_per_step(b), x_bit_identical=_bits_equal([b['x']],
                                                                          [want.x.cpu()])))
    print('mesh over processes (NCCL, one process a card):', json.dumps(dict(
        card=card_line, world_size=world, shards=2 * world, n=PROCS_NCCL_N, dtype='float64',
        eps=EPS, counts=_counts(want_row), per_process=nrows,
        one_process=_per_step(want_row))), flush=True)
    print(f'mesh over processes phase: {time.perf_counter() - t_phase:.1f} s', flush=True)
    return dict(gloo=[r['k2_launches'] for r in rows], nccl=[r['k2_launches'] for r in nrows])


# ---------------------------------------------------------------------------
# Phase 12: the 'ldl' algebra (K5, K6)
# ---------------------------------------------------------------------------

LDL_MAIN = (10_000, 100)  # the main path's Portfolio: assets, factors
LDL_CHECK_PORTFOLIO = (2_000, 20)
LDL_CHECK_BANDED = 4096  # n of the banded check (N = 8192, an elimination-tree chain)
LDL_TIME_BANDED = 1 << 16  # n of the banded timing (N = 131,072)
LDL_K6_REPS = 10
LDL_PROFILE_ITERS = 50  # the profiled warm step's cut (a warm step takes about 200)


def _ldl_stats(fac):
    """Size of a factor: N, nnz(L), the tree's depth, the ordering, the
    factorization's multiply-adds, sum_j Lnz_j (Lnz_j + 1) / 2, the
    supernodes (count, columns, their share of nnz(L)) and K5's launches."""
    lnz = np.diff(fac.Lp).astype(np.float64)
    sym = fac.sym
    w, rows = sym.sn[:, 1].astype(np.float64), sym.sn[:, 2].astype(np.float64)
    return dict(N=fac.n, nnz_L=sym.nnz_L, depth=sym.depth,
                ordering='natural' if fac.perm is None else 'rcm',
                multiply_adds=float(np.sum(lnz * (lnz + 1) / 2)), supernodes=sym.nsup,
                supernode_columns=int(w.sum()),
                supernode_share_of_nnz_L=float(np.sum(w * rows - w * (w + 1) / 2))
                / max(sym.nnz_L, 1), k5_launches_stated=sym.k5_launches)


def ldl_bounds(fac, nnz_K, peak_f64, peak_bytes):
    """K5's and K6's bounds in ms.  K5: its multiply-adds (2 operations
    each) at the f64 peak, or its bytes once (K's values, L's indices in
    both layouts read; L's values in both layouts, D and 1/D written),
    whichever is larger.  K6: L's values read once per pass, 8 bytes an
    entry, plus the vectors (b, x, y, out, 1/D, the permutation) at the
    memory rate: index bytes belong to a layout, not to the work.
    ``k6_with_indices``: the same with L's index bytes read too (4 an entry),
    the bound the row-by-row design stated."""
    st = _ldl_stats(fac)
    nnz, N = st['nnz_L'], st['N']
    k5_ops = 2 * st['multiply_adds'] / peak_f64 * 1e3
    k5_bytes = (nnz_K * 12 + nnz * 8 + nnz * 16 + N * 16) / peak_bytes * 1e3
    k6_bytes = (2 * nnz * 8 + N * 48) / peak_bytes * 1e3
    return dict(k5=(max(k5_ops, k5_bytes), 'operations' if k5_ops >= k5_bytes else 'bytes'),
                k6=(k6_bytes, 'bytes'), k6_with_indices=(2 * nnz * 12 + N * 48) / peak_bytes * 1e3)


def _k5_library(fac):
    """torch.linalg.ldl_factor of the dense KKT matrix on the card, timed
    with CUDA events: a near relative of K5, not the same function (it
    pivots, Bunch-Kaufman, and fills the whole dense triangle); the port
    never calls it.  ``(ms, note)``, or ``(None, reason)``."""
    from osqp_tpu_torch.ops import ldl as tldl

    s = fac.sym
    try:
        K = tldl.dense_kkt(torch.as_tensor(s.Ap, device=DEV), torch.as_tensor(s.Ai, device=DEV),
                           fac.Ax, fac.n)
        ms = cuda_ms(lambda: torch.linalg.ldl_factor(K), 1)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        return None, f'torch.linalg.ldl_factor of the dense KKT: {e}'[:200]
    finally:
        K = None
        torch.cuda.empty_cache()
    return ms, ('torch.linalg.ldl_factor of the dense KKT matrix (Bunch-Kaufman pivoting, '
                'the whole dense triangle): a near relative, not the same function')


def _ldl_plain_factor(fac):
    from osqp_tpu_torch.ops import ldl as tldl

    s = fac.sym
    t = lambda a: torch.as_tensor(a, device=DEV)  # noqa: E731
    return tldl.ldl_factor_plain(t(s.Ap), t(s.Ai), fac.Ax, t(s.Lp), t(s.Li), fac.n)


def _ldl_col_err(fac, Lx):
    """max over L's entries of |K5 - plain| over the column's max-norm (at
    least 1)."""
    nnz = fac.sym.nnz_L
    cols = torch.repeat_interleave(torch.arange(fac.n, device=DEV),
                                   torch.as_tensor(np.diff(fac.Lp), device=DEV))
    scale = torch.zeros(fac.n, dtype=Lx.dtype, device=DEV).scatter_reduce(
        0, cols, Lx.abs(), 'amax')
    if not nnz:
        return 0.0
    return float(((fac.Lx[:nnz] - Lx).abs() / torch.clamp(scale[cols], min=1.0)).max())


def ldl_check(label, K_triu):
    """K5 and K6 against their plain versions on the card in f64: L within
    1e-10 of each column's max-norm, D within 1e-10 relative, n_positive
    equal; the solve within 1e-12 of ||b||_inf (the plain solve on K5's L);
    two K5 runs and two K6 runs bit-identical."""
    from osqp_tpu_torch.ops import ldl as tldl

    fac = tldl.LDLFactor(K_triu, device=DEV)
    Lx, D, _, _ = _ldl_plain_factor(fac)
    err_L = _ldl_col_err(fac, Lx)
    err_D = float(((fac.D - D).abs() / torch.clamp(D.abs(), min=1.0)).max())
    if err_L > 1e-10 or err_D > 1e-10 or fac.n_positive != int((D > 0).sum()):
        raise AssertionError(f'K5 {label}: L err {err_L}, D err {err_D}, n_positive '
                             f'{fac.n_positive} vs {int((D > 0).sum())}')
    L1, D1, Di1 = fac.Lx.clone(), fac.D.clone(), fac.Dinv.clone()
    fac.factor()
    k5_same = (torch.equal(L1, fac.Lx) and torch.equal(D1, fac.D)
               and torch.equal(Di1, fac.Dinv))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(fac.n), device=DEV)
    x1, x2 = fac.solve(b), fac.solve(b)
    k6_same = torch.equal(x1, x2)
    perm = None if fac.perm is None else torch.as_tensor(fac.perm, device=DEV)
    want = tldl.ldl_solve_plain(fac.dense_L(), fac.Dinv, perm, b)
    err_x = float((x1 - want).abs().max()) / float(b.abs().max())
    if err_x > 1e-12 or not (k5_same and k6_same):
        raise AssertionError(f'K6 {label}: err {err_x} of ||b||; bit-identical runs: '
                             f'K5 {k5_same}, K6 {k6_same}')
    row = dict(case=label, **_ldl_stats(fac), k5_err_L=err_L, k5_err_D=err_D,
               k6_err_over_b=err_x, k5_bit_identical=k5_same, k6_bit_identical=k6_same)
    print('ldl check:', json.dumps(row), flush=True)
    return row


def _k6_library(fac, b):
    """One solve by torch's sparse-CSR triangular solve on CUDA (cuSPARSE),
    timed with CUDA events (each call runs cuSPARSE's analysis anew):
    ``(ms, None)``, or ``(None, reason)`` where this torch has none."""
    import scipy.sparse as sparse

    n = fac.n
    L = sparse.csc_matrix((fac.Lx[:fac.sym.nnz_L].cpu().numpy(), fac.sym.Li, fac.sym.Lp),
                          shape=(n, n)) + sparse.eye(n, format='csc')

    def csr(M):
        M = M.tocsr()
        M.sort_indices()
        return torch.sparse_csr_tensor(torch.as_tensor(M.indptr, device=DEV),
                                       torch.as_tensor(M.indices, device=DEV),
                                       torch.as_tensor(M.data, device=DEV), size=M.shape)

    Lc, Ltc = csr(L), csr(L.T)
    perm = None if fac.perm is None else torch.as_tensor(fac.perm, device=DEV)

    def fn():
        bp = (b[perm] if perm is not None else b)[:, None]
        y = torch.triangular_solve(bp, Lc, upper=False, unitriangular=True).solution
        x = torch.triangular_solve(fac.Dinv[:, None] * y, Ltc, upper=True,
                                   unitriangular=True).solution[:, 0]
        if perm is None:
            return x
        out = torch.empty_like(x)
        out[perm] = x
        return out

    try:
        want = fac.solve(b)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / float(b.abs().max())
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f'torch.triangular_solve on a sparse CSR CUDA tensor: {e}'[:200]
    if not err < 1e-8:
        return None, f'torch.triangular_solve on CSR disagrees with K6 ({err} of ||b||)'
    return start.elapsed_time(end), None


def ldl_timing(card, label, K_triu, plain=True):
    """K5 and K6 on the card at one KKT matrix: their device ms (CUDA events
    around one call; K5 also its kernels' summed device time from the
    profiler), launches, bounds, the plain versions' ms (where the dense copy
    fits) and the time of torch's sparse-CSR triangular solve.  Where the
    plain versions run, K5 and K6 are held to them with ``ldl_check``'s
    limits: L within 1e-10 of each column's max-norm, D within 1e-10
    relative, n_positive equal, the solve within 1e-12 of ||b||_inf."""
    from osqp_tpu_torch import tracing
    from osqp_tpu_torch.ops import ldl as tldl

    peak_f64, peak_bytes = peaks(card)[1], peaks(card)[2]
    t0 = time.perf_counter()
    launches = tldl.factor_launches
    sym_ns = tracing.ldl_symbolic_ns
    fac = tldl.LDLFactor(K_triu, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    symbolic_s = (tracing.ldl_symbolic_ns - sym_ns) / 1e9
    launches = tldl.factor_launches - launches
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(fac.n), device=DEV)
    k5_ms = cuda_ms(fac.launch_factor, 3)
    # three calls a profile: a profile of one call of a few long launches
    # (the banded chain) has come back with no device record at all
    k5_busy_ms = device_ms(fac.launch_factor, 3)
    reps = LDL_K6_REPS if fac.sym.depth < 20_000 else 3
    k6_ms = cuda_ms(lambda: fac.solve(b), reps)
    k6_busy_ms = device_ms(lambda: fac.solve(b), reps, name='ldl_solve_kernel')
    bounds = ldl_bounds(fac, int(K_triu.nnz), peak_f64, peak_bytes)
    if launches != fac.sym.k5_launches:
        raise AssertionError(f'K5 {label}: {launches} launches, the symbolic pass states '
                             f'{fac.sym.k5_launches}')
    row = dict(case=label, **_ldl_stats(fac), setup_and_first_factor_s=first_s,
               symbolic_s=symbolic_s, k5_launches=launches, k5_ms=k5_ms,
               k5_busy_ms=k5_busy_ms, k5_bound_ms=bounds['k5'][0], k5_bound_by=bounds['k5'][1],
               k6_launches_per_solve=1, k6_ms=k6_ms, k6_busy_ms=k6_busy_ms,
               k6_bound_ms=bounds['k6'][0], k6_bound_by=bounds['k6'][1],
               k6_bound_with_indices_ms=bounds['k6_with_indices'])
    row['k6_library_ms'], row['k6_library_note'] = _k6_library(fac, b)
    if plain:
        row['k5_library_ms'], row['k5_library_note'] = _k5_library(fac)
    else:
        row['k5_library_ms'] = None
        row['k5_library_note'] = (f'not measured: the dense KKT of N = {fac.n} needs '
                                  f'{fac.n * fac.n * 8 / 1e9:.0f} GB')
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Lx, D, _, Ld = _ldl_plain_factor(fac)
        torch.cuda.synchronize()
        row['k5_plain_ms'] = (time.perf_counter() - t0) * 1e3
        row['k5_err_L'] = _ldl_col_err(fac, Lx)
        row['k5_err_D'] = float(((fac.D - D).abs() / torch.clamp(D.abs(), min=1.0)).max())
        n_pos_plain = int((D > 0).sum())
        if (row['k5_err_L'] > 1e-10 or row['k5_err_D'] > 1e-10
                or fac.n_positive != n_pos_plain):
            raise AssertionError(f"K5 {label}: L err {row['k5_err_L']}, D err "
                                 f"{row['k5_err_D']}, n_positive {fac.n_positive} vs "
                                 f"{n_pos_plain}")
        del Ld, Lx, D
        torch.cuda.empty_cache()
        Lk = fac.dense_L()
        perm = None if fac.perm is None else torch.as_tensor(fac.perm, device=DEV)
        row['k6_plain_ms'] = cuda_ms(lambda: tldl.ldl_solve_plain(Lk, fac.Dinv, perm, b), 3)
        row['k6_err_over_b'] = float(
            (fac.solve(b) - tldl.ldl_solve_plain(Lk, fac.Dinv, perm, b)).abs().max()
        ) / float(b.abs().max())
        if row['k6_err_over_b'] > 1e-12:
            raise AssertionError(f"K6 {label}: err {row['k6_err_over_b']} of ||b||")
        del Lk
    else:
        row['k5_plain_ms'] = row['k6_plain_ms'] = None
        row['plain_note'] = f'not measured: the dense copy of N = {fac.n} needs ' \
                            f'{fac.n * fac.n * 8 / 1e9:.0f} GB'
    del fac
    torch.cuda.empty_cache()
    print('ldl timing:', json.dumps(row), flush=True)
    return row


def ldl_main_path():
    """The main path of the 'ldl' algebra: OSQP(algebra='ldl') on the
    Portfolio at LDL_MAIN (seed 0, f64, eps 1e-3, default settings): setup,
    a cold solve and two warm update(q * 1.01^k) steps, the K5 and K6 counts
    set to 0 just before the setup and read after each step.  Every step
    solved and passing its f64 host termination test; K5 called once per
    factorization (1 + rho updates over setup and the cold solve, the rho
    updates in each warm step), each call as many launches as the symbolic
    pass states (``Symbolic.k5_launches``), K6 launched.  Then a profile of
    one more warm step (cut to LDL_PROFILE_ITERS iterations), and one solve from zero
    iterates (the adapted rho kept) with polishing=True."""
    from osqp_tpu_torch import OSQP, tracing
    from osqp_tpu_torch.ops import ldl as tldl

    P, q, A, l, u = portfolio_family(*LDL_MAIN)
    torch.cuda.synchronize()
    tldl.factor_launches = tldl.factor_calls = tldl.solve_launches = 0
    t0 = time.perf_counter()
    c0 = tracing.counters()
    o = OSQP(device=DEV, algebra='ldl')
    o.setup(P=P, q=q, A=A, l=l, u=u, eps_abs=EPS, eps_rel=EPS, verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # setup's split on the host clock, from the port's spans
    c1 = tracing.counters()
    setup_split = {f'{span}_s': (c1[f'{span}_ns'] - c0[f'{span}_ns']) / 1e9
                   for span in ('setup_scale', 'ldl_symbolic', 'ldl_factor', 'kernel_load')}
    k5, k6 = [tldl.factor_calls], [tldl.solve_launches]
    qs, results, times = [], [], []
    for k in range(FAMILY_WARM + 1):
        qs.append(q * 1.01 ** k)
        t0 = time.perf_counter()
        if k:
            o.update(q=qs[k])
        results.append(o.solve(raise_error=False))
        times.append(time.perf_counter() - t0)
        k5.append(tldl.factor_calls)
        k6.append(tldl.solve_launches)
    # K5 calls: setup and the cold solve together, then each warm step
    k5_steps = [k5[1]] + [k5[i + 1] - k5[i] for i in range(1, len(results))]
    k6_steps = [k6[i + 1] - k6[i] for i in range(len(results))]
    statuses = [r.info.status for r in results]
    if any(st != 'solved' for st in statuses):
        raise AssertionError(f'ldl main path: statuses {statuses}')
    rho_updates = [r.info.rho_updates for r in results]
    want_k5 = [1 + rho_updates[0]] + rho_updates[1:]
    fac = o._solver._kkt.factor
    k5_launches = tldl.factor_launches
    # every call so far factors the same pattern: the symbolic pass's
    # count, once per call
    if (k5_steps != want_k5 or min(k6_steps) <= 0
            or k5_launches != tldl.factor_calls * fac.sym.k5_launches):
        raise AssertionError(f'ldl main path: K5 calls {k5_steps} (want {want_k5}), '
                             f'{k5_launches} K5 launches, K6 launches {k6_steps}')
    ratios = [sparse_residual_check(P, A, l, u, qk, r.x, r.y, EPS) for qk, r in zip(qs, results)]
    summary = dict(
        n=P.shape[0], m=A.shape[0], nnz_A=int(A.nnz), **_ldl_stats(fac),
        formats=[o._solver._sparse_fmt_P, o._solver._sparse_fmt_A],
        setup_s=setup_s, setup_split=setup_split, cold_solve_s=times[0],
        warm_solve_s=times[1:], statuses=statuses, admm_iters=[r.info.iter for r in results],
        rho_updates=rho_updates, host_syncs=[r.info.host_syncs for r in results],
        k5_calls=k5_steps, k5_launches=k5_launches, k6_launches=k6_steps,
        residual_over_bound=ratios,
        gap_over_bound=[gap_over_bound(r.info, EPS) for r in results],
        device_mem_gb=torch.cuda.memory_allocated() / 1e9)
    # a profile of one more warm step, cut to LDL_PROFILE_ITERS iterations
    o.update(q=q * 1.01 ** (FAMILY_WARM + 1))
    o.update_settings(max_iter=LDL_PROFILE_ITERS)
    r, wall_ms, kernels = _profiled(lambda: o.solve(raise_error=False))
    o.update_settings(max_iter=4000)
    prof = _profile_numbers(wall_ms, kernels)
    busy = prof['device_busy_ms']
    k6_busy = sum(e.self_device_time_total for e in kernels if 'ldl_solve' in e.key) / 1e3
    k5_busy = sum(e.self_device_time_total for e in kernels if 'ldl_factor' in e.key) / 1e3
    prof.update(status=r.info.status, iters=r.info.iter, rho_updates=r.info.rho_updates,
                k6_share_of_busy=k6_busy / busy, k5_share_of_busy=k5_busy / busy)
    summary['warm_profile'] = prof
    # one solve from zero iterates with the polish
    o.update(q=q)
    o.update_settings(polishing=True, warm_starting=False)
    t0 = time.perf_counter()
    rp = o.solve(raise_error=False)
    pol = dict(status=rp.info.status, status_polish=rp.info.status_polish, iters=rp.info.iter,
               solve_s=time.perf_counter() - t0, polish_s=rp.info.polish_time)
    if rp.info.status != 'solved':
        raise AssertionError(f'ldl polish run: status {rp.info.status}')
    if rp.info.status_polish == 1:
        pol['residual_over_bound'] = sparse_residual_check(P, A, l, u, q, rp.x, rp.y, EPS)
    summary['polish'] = pol
    summary['k5_calls_total'] = tldl.factor_calls
    summary['k5_launches_total'] = tldl.factor_launches
    summary['k6_launches_total'] = tldl.solve_launches
    print('ldl main path:', json.dumps(summary), flush=True)
    del o
    torch.cuda.empty_cache()
    return summary


def ldl_card_vs_cpu():
    """The 'ldl' algebra on the card against the CPU (the plain versions)
    in f64: the Portfolio at LDL_CHECK_PORTFOLIO and tests/problems.py's
    feasibility and primal_infeasible families: statuses equal, iterations
    within 5%, x within 1e-6 of ||x|| (the certificate where infeasible).
    Then a non-convex P raises OSQP_NONCVX_ERROR on the card through K5's
    inertia."""
    sys.path.insert(0, str(ROOT / 'tests'))
    import problems
    from osqp_tpu_torch import OSQP
    from osqp_tpu_torch.constants import SolverError
    from osqp_tpu_torch.exceptions import OSQPException
    from osqp_tpu_torch.ops import ldl as tldl

    out = []
    for name, build in (('portfolio', lambda: portfolio_family(*LDL_CHECK_PORTFOLIO)),
                        ('feasibility', problems.feasibility),
                        ('primal_infeasible', problems.primal_infeasible)):
        data = build()
        res = {}
        for dev in (DEV, 'cpu'):
            t0 = time.perf_counter()
            o = OSQP(device=dev, algebra='ldl')
            o.setup(*data, verbose=False)
            res[dev] = (o.solve(raise_error=False), time.perf_counter() - t0)
        (g, g_s), (c, c_s) = res[DEV], res['cpu']
        if g.info.status != c.info.status or abs(g.info.iter - c.info.iter) > 0.05 * c.info.iter:
            raise AssertionError(f'ldl {name}: card {g.info.status} in {g.info.iter}, cpu '
                                 f'{c.info.status} in {c.info.iter}')
        a, b = (g.x, c.x) if c.info.status == 'solved' else (g.prim_inf_cert, c.prim_inf_cert)
        err = float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
        if not err <= 1e-6:
            raise AssertionError(f'ldl {name}: card against cpu {err}')
        out.append(dict(case=name, status=g.info.status, iters=[g.info.iter, c.info.iter],
                        rho_updates=[g.info.rho_updates, c.info.rho_updates], rel_err=err,
                        card_s=g_s, cpu_s=c_s))
    before = tldl.factor_calls
    try:
        OSQP(device=DEV, algebra='ldl').setup(*problems.non_convex(), verbose=False)
        raise AssertionError('ldl: a non-convex P did not raise on the card')
    except OSQPException as e:
        if e.args[0] != int(SolverError.OSQP_NONCVX_ERROR) or tldl.factor_calls != before + 1:
            raise AssertionError(f'ldl non-convex: error {e.args}, K5 calls '
                                 f'{tldl.factor_calls - before}')
    out.append(dict(case='non_convex', raised='OSQP_NONCVX_ERROR', k5_calls=1))
    print('ldl card vs cpu:', json.dumps(out), flush=True)
    return out


def ldl_phase(card):
    """Phase 12: K5 and K6 checked and timed, the main path, the card
    against the CPU.  Returns (timing rows, main path summary)."""
    def kkt(prob):
        P, _, A, _, _ = prob
        return kkt_triu(P, A)

    t_phase = time.perf_counter()
    ldl_check(f'portfolio {LDL_CHECK_PORTFOLIO[0]}x{LDL_CHECK_PORTFOLIO[1]}',
              kkt(portfolio_family(*LDL_CHECK_PORTFOLIO)))
    ldl_check(f'banded n={LDL_CHECK_BANDED}', kkt(banded_qp(LDL_CHECK_BANDED)))
    rows = [ldl_timing(card, f'portfolio {LDL_MAIN[0]}x{LDL_MAIN[1]}',
                       kkt(portfolio_family(*LDL_MAIN))),
            ldl_timing(card, f'banded n={LDL_TIME_BANDED}', kkt(banded_qp(LDL_TIME_BANDED)),
                       plain=False)]
    main = ldl_main_path()
    ldl_card_vs_cpu()
    print(f'ldl phase: {time.perf_counter() - t_phase:.1f} s', flush=True)
    return rows, main


def main():
    import argparse

    ap = argparse.ArgumentParser(description='Run the port on one NVIDIA GPU and check it.')
    ap.add_argument('--k1', action='store_true',
                    help='build K1 and run only its phase (3), then stop without a result line')
    ap.add_argument('--mesh-worker', choices=('gloo', 'nccl'),
                    help="run as one process of phase 11b's mesh (started by this script)")
    ap.add_argument('--rank', type=int)
    ap.add_argument('--world', type=int)
    ap.add_argument('--init')
    ap.add_argument('--out')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is False)', file=sys.stderr)
        return 1
    if not (ROOT / 'osqp_tpu_torch' / 'ops' / 'csrc').is_dir():
        print(f'chip_smoke: osqp_tpu_torch not found beside {__file__}', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.mesh_worker:
        return mesh_worker(args.mesh_worker, args.rank, args.world, args.init, args.out)
    from osqp_tpu_torch.ops import _build
    from osqp_tpu_torch.ops import dia_matvec as dm
    from osqp_tpu_torch.ops import shared_epoch as se

    # 1. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    def mark(phase):
        print(f'[{time.perf_counter() - t_start:.1f} s] {phase} done', flush=True)

    kind = torch.cuda.get_device_name(0)
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}')
    print(card_line, flush=True)
    if args.k1:
        lib = _build.build('shared_epoch')
        print(lib.with_suffix('.log').read_text().strip(), flush=True)
        print('k1:', json.dumps(kernel_phase(kind)), flush=True)
        return 0

    # 2. build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    libs = _build.build_all(['shared_epoch', 'dia_matvec', 'ell_matvec', 'bsr_matvec',
                             'ldl_factor', 'ldl_solve'])
    libs.append(_build.build_host('ldl_host'))  # the LDL' symbolic pass (g++)
    print(f'built {", ".join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s')
    for lib in libs:
        print(lib.with_suffix('.log').read_text().strip(), flush=True)

    # 3. K1 against its plain version
    rows = kernel_phase(kind)
    mark('phase 3 (K1)')

    # 4. the batched main path in each mode, with the launch counts read
    # around each run
    batched = {}
    for iter_prec, steps, over in (('highest', STEPS, {}), ('high', STEPS, {}),
                                   ('default', 0, dict(max_iter=500))):
        se.launches = dm.launches = 0
        run = main_path(iter_prec, steps, **over)
        summary = batched_summary(run, iter_prec, steps, se.launches)
        print(f'main path ({iter_prec}):', json.dumps(summary), flush=True)
        if steps:
            prof = profile_rollout(run)
            summary['profile'] = prof
            print(f'warm rollout profile ({iter_prec}):', json.dumps(prof), flush=True)
        batched[iter_prec] = summary
    launches = batched['highest']['kernel_launches']
    print('main path iterations by mode:', json.dumps({
        k: dict(mean_iters_cold=v['mean_iters_cold'], mean_iters_warm=v.get('mean_iters_warm'),
                warm_solves_per_s=v.get('warm_solves_per_s')) for k, v in batched.items()}),
        flush=True)
    print("'high' mean iterations over 'highest''s: cold "
          f"{batched['high']['mean_iters_cold'] / batched['highest']['mean_iters_cold']:.4f}, "
          f"warm {batched['high']['mean_iters_warm'] / batched['highest']['mean_iters_warm']:.4f}",
          flush=True)
    mark('phase 4 (shared engine)')

    # 4b-4d. the vmap engine, batch_qp_solve and mpc_rollout, and the
    # differentiable layers (no hand-written kernel on these paths)
    vmap_phase()
    mark('phase 4b (vmap engine)')
    rollout_phase()
    mark('phase 4c (batch_qp_solve, mpc_rollout)')
    layer_phase()
    mark('phase 4d (layers)')

    # 5. K2 against its plain version
    dia_rows = dia_phase(kind)
    mark('phase 5 (K2)')

    # 6. the sparse single-QP main path, with the launch counts read around it
    # (the model is also exported right after its setup: phase 10)
    exports = Exports()
    se.launches = dm.launches = 0
    sp_run = sparse_main_path(torch.float32, export=exports)
    dia_launches = dm.launches
    if dia_launches <= 0:
        raise AssertionError('the sparse main path never launched the dia_matvec kernel')
    sp_ratio = sparse_checks(sp_run)
    sp_res = sp_run['results']
    sp_summary = dict(
        n=SPARSE_N, m=SPARSE_N, eps=EPS, dtype='float32',
        formats=[sp_run['solver']._solver._sparse_fmt_P, sp_run['solver']._solver._sparse_fmt_A],
        setup_s=sp_run['setup_s'], cold_solve_s=sp_run['times'][0],
        warm_solve_s=sp_run['times'][1:], statuses=[r.info.status for r in sp_res],
        admm_iters=[r.info.iter for r in sp_res], cg_steps=[r.info.cg_iters for r in sp_res],
        host_syncs=[r.info.host_syncs for r in sp_res], rho_updates=[r.info.rho_updates for r in sp_res],
        dia_launches=dia_launches, residual_over_bound=sp_ratio,
    )
    print('sparse main path:', json.dumps(sp_summary), flush=True)
    print('sparse card vs cpu (n=16384, f64):', json.dumps(sparse_card_vs_cpu()), flush=True)
    print('sparse warm step profile:', json.dumps(profile_sparse(sp_run)), flush=True)
    mark('phase 6 (sparse path)')

    # 7. polish, time_limit, SIGINT and verbose on the single-QP path
    pol = sparse_polish_path(sp_run)
    print('sparse polish (n=2^20):', json.dumps(pol), flush=True)
    print('polish card vs cpu (n=16384, f64):', json.dumps(polish_card_vs_cpu()), flush=True)
    for density in (0.01, 0.002):
        print('dense polish (n=2000, m=3000):', json.dumps(dense_polish_path(density)), flush=True)
    print('rejected polish, line search (n=30):', json.dumps(rejected_polish()), flush=True)
    tl = time_limit_path(sp_run)
    print('time_limit (n=2^20):', json.dumps(tl), flush=True)
    print('SIGINT (n=2^20):', json.dumps(sigint_path(sp_run, tl['solve_time_s'])), flush=True)
    print('verbose (n=2^20):', json.dumps(verbose_path(sp_run)), flush=True)
    del sp_run
    mark('phase 7 (polish, time_limit, SIGINT, verbose)')

    # 8. the ELL, BSR and BCOO single-QP paths, each with its launch counts
    # read around it, then K3 and K4 against their plain versions on those
    # paths' own operators and on ragged shapes
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fam = {}
    fam['ell'], o = family_path('ell', lambda: ell_family(ELL_N), ('ell', 'ell'), 'ell_matvec',
                                export=exports)
    k3_rows = ell_rows(kind, o, flush)
    ladder_rows(o, 'ell')
    del o
    torch.cuda.empty_cache()
    fam['bsr'], o = family_path('bsr', lambda: clustered_family(CLUSTER_NSB, CLUSTER_NSB),
                                ('bsr', 'bsr'), 'bsr_matvec', export=exports)
    k4_rows = bsr_rows(kind, o, flush)
    ladder_rows(o, 'bsr')
    del o
    torch.cuda.empty_cache()
    # the Portfolio path runs its cold solve only, cut to PORTFOLIO_MAX_ITER
    # iterations: a solve takes about 64 s at the default 4000, and the run
    # has to stay inside half its time limit
    fam['portfolio'], o = family_path(
        'portfolio', lambda: portfolio_family(PORTFOLIO_N, PORTFOLIO_K), ('dia', 'bcoo'),
        'dia_matvec', solved=False, profile_iters=50, warm=0, max_iter=PORTFOLIO_MAX_ITER)
    ladder_rows(o, 'portfolio')
    del o
    torch.cuda.empty_cache()

    # 9. the three families card against CPU at a small size, and the
    # derivatives card against CPU
    mark('phase 8 (ELL, BSR, Portfolio)')
    families_card_vs_cpu()
    derivatives_card_vs_cpu()
    mark('phase 9 (card vs cpu)')

    # 10. codegen and export: the exported programs of phases 6 and 8 (run
    # there, right after each setup) and the dense direct one, then the C
    # emitter compiled and solved on this machine
    codegen_phase(exports)
    mark('phase 10 (codegen and export)')
    export_launches = {k: sum(r['launches'][k] for r in exports.runs.values())
                       for k in ('dia_matvec', 'ell_matvec', 'bsr_matvec')}

    # 11. the multi-device package: banded (K2 on every shard's halo
    # window), bigqp and dp_mp on shards of the card(s)
    _, halo_rows, banded_launches, par_ref = parallel_phase(kind)
    mark('phase 11 (multi-device)')

    # 11b. the same paths on a mesh over processes: gloo processes sharing
    # the card, then NCCL with one process a card
    procs_launches = procs_phase(card_line, par_ref)
    del par_ref
    mark('phase 11b (mesh over processes)')

    # 12. the 'ldl' algebra: K5 and K6 against their plain versions and
    # timed, its main path (the Portfolio at 10,000 x 100), card against CPU
    ldl_rows, ldl_main = ldl_phase(kind)
    mark('phase 12 (ldl algebra)')

    # 13. the kernels line and the result line
    head = rows[0]
    dia_head = dia_rows[0]  # P @ v, float32, n = 2^20: the sparse path's widest operator
    modes = {}
    for iter_prec in ('high', 'default'):  # each at the f32 headline
        r = next(r for r in rows if r['iter_prec'] == iter_prec)
        modes[iter_prec] = dict(
            launches=batched[iter_prec]['kernel_launches'], max_abs_err=r['max_abs_err'],
            max_abs_err_K1=r['max_abs_err_K1'], status_mismatch=r['status_mismatch'],
            design=r['plan']['design'], ms=r['ms'], ms_K0=r['ms_K0'],
            per_iter_us=r['per_iter_us'], ratio_to_highest=r['ratio_to_highest'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'])
    hi_rows = [r for r in rows if r['iter_prec'] == 'highest']
    kernels = [dict(
        name='shared_epoch', route='cuda', source='osqp_tpu_torch/ops/csrc/shared_epoch.cu',
        replaces='osqp_tpu/ops/shared_epoch.py:75', launches=launches,
        max_abs_err=max(r['max_abs_err'] for r in hi_rows),
        max_err=max(r['max_abs_err'] for r in hi_rows),
        ms=head['ms'], events_ms=head['events_ms'], plain_ms=head['plain_ms'],
        bound_ms=head['bound_ms'], bound_by=head['bound_by'], library_ms=head['library_ms'],
        shape=f"B={head['B']} n={head['n']} m={head['m']} {head['dtype']}", modes=modes,
    ), dict(
        name='dia_matvec', route='cuda', source='osqp_tpu_torch/ops/csrc/dia_matvec.cu',
        replaces='tools/proto_dia_pallas.py:25', plain_of='osqp_tpu/ops/spmv.py:79',
        launches=dia_launches, polish_launches_f64=pol['polish_dia_launches'],
        max_abs_err=max(r['max_abs_err'] for r in dia_rows),
        ms=dia_head['ms'], plain_ms=dia_head['plain_ms'], bound_ms=dia_head['bound_ms'],
        bound_by=dia_head['bound_by'], library_ms=dia_head['library_ms'],
        shape=f"{dia_head['case']} D={dia_head['D']} m={dia_head['m_out']} {dia_head['dtype']}",
        portfolio_launches=fam['portfolio']['launches']['dia_matvec'],
        export_launches=export_launches['dia_matvec'], banded_launches=banded_launches,
        banded_process_launches=procs_launches,
        banded_window_ms={f"{r['case'].split()[0]} {r['dtype']}": r['ms'] for r in halo_rows},
        banded_window_cold_l2_ms={f"{r['case'].split()[0]} {r['dtype']}": r['cold_l2_ms']
                                  for r in halo_rows},
    )]
    for name, rows_k, path, plain_of in (
            ('ell_matvec', k3_rows, 'ell', 'osqp_tpu/ops/spmv.py:240'),
            ('bsr_matvec', k4_rows, 'bsr', 'osqp_tpu/ops/spmv.py:297')):
        # A @ v of the path's own operator, float64
        head = next(r for r in rows_k if r['case'] == 'A @ v' and r['dtype'] == 'float64')
        kernels.append(dict(
            name=name, route='cuda', source=f'osqp_tpu_torch/ops/csrc/{name}.cu', replaces=None,
            plain_of=plain_of, launches=fam[path]['launches'][name],
            max_abs_err=max(r['max_abs_err'] for r in rows_k),
            max_rel_err=max(r['max_rel_err'] for r in rows_k), ms=head['ms'],
            cold_l2_ms=head['cold_l2_ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            padded_bound_ms=head['padded_bound_ms'], library_ms=head['library_ms'],
            ms_over_library=head['ms_over_library'], export_launches=export_launches[name],
            **{k: head[k] for k in ('lens_mean', 'lanes_per_row', 'nblk_mean') if k in head},
            shape=f"{head['case']} m={head['m']} n={head['n']} {head['dtype']} ({path} path)"))
    ldl_head = ldl_rows[0]  # the main path's KKT matrix
    for name, k, replaces_host in (('ldl_factor', 'k5', 'osqp_tpu/native/ldl.cpp:52'),
                                   ('ldl_solve', 'k6', 'osqp_tpu/native/ldl.cpp:102')):
        kernels.append(dict(
            name=name, route='cuda', source=f'osqp_tpu_torch/ops/csrc/{name}.cu', replaces=None,
            replaces_host=replaces_host, launches=ldl_main[f'{k}_launches_total'],
            **({'factor_calls': ldl_main['k5_calls_total'],
                'launches_per_factor': ldl_head['k5_launches']} if k == 'k5'
               else {'bound_with_indices_ms': ldl_head['k6_bound_with_indices_ms']}),
            max_abs_err=ldl_head[f'{k}_err_L' if k == 'k5' else 'k6_err_over_b'],
            ms=ldl_head[f'{k}_ms'], busy_ms=ldl_head[f'{k}_busy_ms'],
            plain_ms=ldl_head[f'{k}_plain_ms'], bound_ms=ldl_head[f'{k}_bound_ms'],
            bound_by=ldl_head[f'{k}_bound_by'], library_ms=ldl_head[f'{k}_library_ms'],
            library_note=ldl_head[f'{k}_library_note'],
            banded_ms=ldl_rows[1][f'{k}_ms'], banded_bound_ms=ldl_rows[1][f'{k}_bound_ms'],
            shape=f"{ldl_head['case']} KKT: N={ldl_head['N']} nnz(L)={ldl_head['nnz_L']} "
                  f"depth={ldl_head['depth']} supernodes={ldl_head['supernodes']} "
                  f"({ldl_head['supernode_columns']} columns) f64"))
    print(card_line)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
