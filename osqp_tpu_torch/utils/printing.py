"""Verbose console protocol: setup header with problem/settings summary,
periodic iteration rows, polish row and a status footer.

The port's own copy of ``osqp_tpu/utils/printing.py``; every line but the
banner's two title lines is character for character the JAX package's.
``print_loop_row`` is the solve loop's row, which the JAX package prints from
inside its jitted loop (``osqp_tpu/solver/core.py``).
"""

from __future__ import annotations


def print_setup_header(n, m, nnz, stg, algebra, solver_type, version, device):
    print('--------------------------------------------------------------')
    print(f'           osqp_tpu_torch v{version}  -  OSQP-class solver on PyTorch')
    print(f'           algebra = {algebra} ({device}), linear system solver = {solver_type}')
    print('--------------------------------------------------------------')
    print(f'problem:  variables n = {n}, constraints m = {m}')
    print(f'          nnz(P) + nnz(A) = {nnz}')
    print('settings: ', end='')
    print(f'eps_abs = {stg.eps_abs:.2e}, eps_rel = {stg.eps_rel:.2e},')
    print(f'          eps_prim_inf = {stg.eps_prim_inf:.2e}, eps_dual_inf = {stg.eps_dual_inf:.2e},')
    print(f'          rho = {stg.rho:.2e} ', end='')
    print('(adaptive)' if stg.adaptive_rho else '')
    print(f'          sigma = {stg.sigma:.2e}, alpha = {stg.alpha:.2f}, ', end='')
    print(f'max_iter = {int(stg.max_iter)}')
    print(f'          scaling: {"on" if stg.scaling else "off"}, ', end='')
    print(f'scaled_termination: {"on" if stg.scaled_termination else "off"}')
    print(f'          warm_starting: {"on" if stg.warm_starting else "off"}, ', end='')
    print(f'polishing: {"on" if stg.polishing else "off"}')
    print('')


def print_iter_header():
    print('iter   objective    pri res    dua res    rho       time')


def print_loop_row(it, obj, pri, dua, rho):
    print(f'{it:4d}  {obj:.4e}  {pri:.2e}  {dua:.2e}  {rho:.2e}')


def print_iter_row(it, obj, pri, dua, rho, runtime):
    print(f'{it:4d}  {obj:11.4e}   {pri:8.2e}   {dua:8.2e}   {rho:8.2e}  {runtime:8.2e}s')


def print_polish_row(obj, pri, dua, runtime):
    print(f'plsh  {obj:11.4e}   {pri:8.2e}   {dua:8.2e}   --------  {runtime:8.2e}s')


def print_footer(info, polishing):
    print('')
    print(f'status:               {info.status}')
    if polishing and info.status_val == 1:
        if info.status_polish == 1:
            print('solution polish:      successful')
        elif info.status_polish == -1:
            print('solution polish:      unsuccessful')
    print(f'number of iterations: {info.iter}')
    if info.status_val in (1, 2):
        print(f'optimal objective:    {info.obj_val:.4f}')
        print(f'run time:             {info.run_time:.2e}s')
    print(f'optimal rho estimate: {info.rho_estimate:.2e}')
    print('')
