#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (osqp_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build of every kernel from the sources in the checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, one epoch from
   the same state, at the main path's shapes: f32 at B=4096, n=32, m=48
   (the batched condensed-MPC headline), f32 at B=1024, n=128, m=192, and
   f64 at a ragged B=333, n=13, m=19; with the kernel's, the plain version's
   and the unfused torch epoch's times;
4. the main path end to end: BatchedOSQP setup, cold solve, then a 10-step
   warm MPC rollout (update(q) with q + 0.01 noise, then solve) at the
   headline shape in f32, eps 1e-3.  Every instance must be solved, every
   returned solution must pass its termination test recomputed on the host in
   float64, 64 instances must lie near the port's own float64 CPU optimum at
   every step, and every kernel of the path must have launched;
5. a JSON line with each kernel's numbers, then the result line
   {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  It needs the repository's
``osqp_tpu_torch`` beside it and a CUDA device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of the cards this may run on (NVIDIA data sheets, dense, without
# tensor cores for fp32/fp64): (fp32 FLOP/s, fp64 FLOP/s, memory bytes/s).
PEAKS = {
    'H100 PCIe': (51.2e12, 25.6e12, 2.0e12),
    'H100 NVL': (60e12, 30e12, 3.9e12),
    'H100': (67e12, 34e12, 3.35e12),  # SXM5
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
    S, dX, dY = se.affine_iterations(F, c0, rvec, rinv, L, U, S0, dX0, dY0, sc.alpha, sc.K)
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


def compare(got, want, tol):
    """Statuses identical; every other output within ``tol`` times the
    larger of 1 and the state's magnitude, with non-finite entries (the
    objective of infeasible or non-convex columns) in the same places.
    Returns the largest absolute difference."""
    if not torch.equal(got[6], want[6]):
        bad = int((got[6] != want[6]).sum())
        raise AssertionError(f'statuses differ in {bad} columns')
    scale = max(1.0, float(want[0].abs().max()))
    worst = 0.0
    for name, g, w in zip(_OUT_NAMES, got, want):
        if name == 'status':
            continue
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


def epoch_bound_ms(B, n, m, itemsize, n_active, peak_flops, peak_bytes):
    """Least time for one epoch: iterations of the active columns plus the
    termination check of every column, against one read of each input and
    one write of each output."""
    nm, N2 = n + m, n + 2 * m
    flops = K * 2 * nm * N2 * n_active + (4 * nm * n + 4 * n * m) * B
    state = (2 * N2 + 2 * n + 2 * m) * B  # S, fS, dX, dY, fdX, fdY
    reads = state + (nm + n + 2 * m) * B + nm * N2 + nm * n + n * m + 2 * n + 4 * m
    writes = state + 4 * B
    nbytes = (reads + writes) * itemsize + 2 * 4 * B  # + status in and out (int32)
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes else 'bytes')


def kernel_phase(card):
    from osqp_tpu_torch.ops import shared_epoch as se

    f32_peak, f64_peak, mem_peak = peaks(card)
    rows = []
    shapes = ((torch.float32, HEADLINE, 2e-4), (torch.float32, (1024, 128, 192), 2e-4),
              (torch.float64, (333, 13, 19), 1e-9))
    # tolerances: f32 sums run in another order and with FMA contraction in
    # the kernel; over 25 iterations of a nonexpansive map that stays within
    # a few 1e-6 of the state's scale, so 2e-4 leaves room; f64 the same at
    # 1e-9.
    for dtype, (B, n, m), tol in shapes:
        fixed, state, sc, ctx = epoch_inputs(B, n, m, dtype, seed=0)
        got = se.shared_epoch(*fixed, *state, sc)
        torch.cuda.synchronize()
        want = se.shared_epoch_plain(*fixed, *state, sc)
        err = compare(got, want, tol)
        unf = unfused_epoch(fixed, state, sc, ctx)
        compare(unf, want, tol)
        reps = 20
        ms = cuda_ms(lambda: se.shared_epoch(*fixed, *state, sc), reps)
        plain_ms = cuda_ms(lambda: se.shared_epoch_plain(*fixed, *state, sc), 5)
        lib_ms = cuda_ms(lambda: unfused_epoch(fixed, state, sc, ctx), 5)
        n_active = int((state[6] == se.UNSOLVED).sum())
        item = torch.empty((), dtype=dtype).element_size()
        bound, by = epoch_bound_ms(B, n, m, item, n_active,
                                   f32_peak if dtype == torch.float32 else f64_peak, mem_peak)
        row = dict(dtype=str(dtype).replace('torch.', ''), B=B, n=n, m=m, active=n_active,
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound, bound_by=by)
        print('shared_epoch vs plain:', json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main_path():
    """BatchedOSQP setup, cold solve and the 10-step warm rollout at the
    headline shape, f32 on the card.  Returns the run's numbers."""
    from osqp_tpu_torch import BatchedOSQP

    B, n, m = HEADLINE
    P, q, A, l, u = build_shared_problems(B, n, m, seed=0)
    noise = np.random.default_rng(1).standard_normal((STEPS, B, n))
    kw = dict(eps_abs=EPS, eps_rel=EPS, verbose=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = BatchedOSQP(dtype=torch.float32, device=DEV)
    s.setup(P, q, A, l, u, **kw)
    r = s.solve()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = [r]
    for k in range(STEPS):
        s.update(q=q + 0.01 * noise[k])
        results.append(s.solve())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(results=results, setup_cold_s=t1 - t0, warm_s=t2 - t1, P=P, q=q, A=A, l=l,
                u=u, noise=noise, kw=kw, solver=s)


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
    inf-norm.  The solver tests ||Ax - z|| with z in [l, u], which bounds the
    first from above; 5% and 1e-4 of slack cover the float32 rounding of the
    returned iterates.  Returns the largest ratio of residual to bound."""
    P, A, l, u, q = run['P'], run['A'], run['l'], run['u'], run['q']
    eps = run['kw']['eps_abs']
    worst = 0.0
    for k, r in enumerate(run['results']):
        qk = q if k == 0 else q + 0.01 * run['noise'][k - 1]
        x = r.x.astype(np.float64)
        y = r.y.astype(np.float64)
        Ax = x @ A.T
        proj = np.clip(Ax, l, u)
        Px, Aty = x @ P.T, y @ A

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
    float64 CPU solve of the same QPs to eps 1e-7.  The card stops at eps
    1e-3, which on this problem family leaves x up to about 1.5e-2 from the
    optimum (measured with the port on the CPU at B=512 and 2048), so the
    bound is 5e-2: a check that the card solved the same problems, while
    residual_check holds the accuracy.  Returns the largest |x - x*|."""
    from osqp_tpu_torch import BatchedOSQP

    sl = slice(0, n_check)
    ref = BatchedOSQP(dtype=torch.float64, device='cpu')
    ref.setup(run['P'], run['q'][sl], run['A'], run['l'][sl], run['u'][sl],
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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is False)', file=sys.stderr)
        return 1
    if not (ROOT / 'osqp_tpu_torch' / 'ops' / 'csrc').is_dir():
        print(f'chip_smoke: osqp_tpu_torch not found beside {__file__}', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from osqp_tpu_torch.ops import _build
    from osqp_tpu_torch.ops import shared_epoch as se

    # 1. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}')
    print(card_line, flush=True)

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    lib = _build.build('shared_epoch')
    print(f'built {lib.name} in {time.perf_counter() - t0:.2f} s')
    print(lib.with_suffix('.log').read_text().strip(), flush=True)

    # 3. each kernel against its plain version
    rows = kernel_phase(kind)

    # 4. the main path, with the launch counts read around it
    se.launches = 0
    run = main_path()
    launches = se.launches
    if launches <= 0:
        raise AssertionError('the main path never launched the shared_epoch kernel')
    statuses = np.stack([r.info.status_val for r in run['results']])
    if not (statuses == 1).all():
        raise AssertionError(f'{int((statuses != 1).sum())} instance-solves not solved')
    res_ratio = residual_check(run)
    ref_err = reference_check(run)
    B = HEADLINE[0]
    iters = np.stack([r.info.iter for r in run['results']])
    summary = dict(
        B=B, n=HEADLINE[1], m=HEADLINE[2], eps=EPS, dtype='float32', steps=STEPS,
        setup_and_cold_solve_s=run['setup_cold_s'], warm_rollout_s=run['warm_s'],
        warm_solves_per_s=B * STEPS / run['warm_s'],
        mean_iters_cold=float(iters[0].mean()), mean_iters_warm=float(iters[1:].mean()),
        max_iters=int(iters.max()), kernel_launches=launches,
        residual_over_bound=res_ratio, x_err_vs_f64_optimum=ref_err,
    )
    print('main path:', json.dumps(summary), flush=True)
    print('warm rollout profile:', json.dumps(profile_rollout(run)), flush=True)

    head = rows[0]
    kernels = [dict(
        name='shared_epoch', route='cuda', source='osqp_tpu_torch/ops/csrc/shared_epoch.cu',
        replaces='osqp_tpu/ops/shared_epoch.py:75', launches=launches,
        max_abs_err=max(r['max_abs_err'] for r in rows), max_err=max(r['max_abs_err'] for r in rows),
        ms=head['ms'], kernel_ms=head['ms'], plain_ms=head['plain_ms'],
        bound_ms=head['bound_ms'], bound_by=head['bound_by'], library_ms=head['library_ms'],
        shape=f"B={head['B']} n={head['n']} m={head['m']} {head['dtype']}",
    )]
    print(card_line)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
