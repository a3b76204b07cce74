"""What decides ``correct``: the answers of sampled steps against the plain
reference (``reference/ipm.py``, float64), on the same recorded inputs.

Each answer of the system under test says: a status, x and y, and two
numbers computed from them, the objective and the dual residual.  Three
numbers are compared, each with the limit the configuration's file gives
under ``limits``:

- ``status_mismatch``: answers whose status is not the reference's (the
  reference solves every sampled QP to 1e-9 and finds it solved).  An exact
  comparison: limit 0.
- ``term_ratio``: the largest, over answers that say solved, of the
  termination test recomputed in float64 from x and y, ||Ax - proj(Ax)|| /
  (eps_abs + eps_rel max(||Ax||, ||proj(Ax)||)) and ||Px + q + A'y|| /
  (eps_abs + eps_rel max(||Px||, ||A'y||, ||q||)), inf-norms.  The
  configuration states eps; the limit leaves 1% for the rounding of the
  returned x and y.
- ``claim_gap``: the largest gap between what an answer says of itself
  (objective, dual residual) and the same recomputed in float64 from its x
  and y, each over the size of the terms it sums (|x'Px / 2| + |q'x|; the
  largest of ||Px||, ||A'y||, ||q||).  It reads the arithmetic in which the
  answer's own report was computed, not the precision of the iterations
  that led to x and y: iterations in a lower precision whose report is
  computed in the configuration's pass it.

Beside them, not compared: ``x_gap``, the largest ||x - x_ref|| / (1 +
||x_ref||) (inf-norms), the answers' distance from the reference optimum,
which eps sets: the control, the reference in a lower precision, lands as
near the optimum as the system does, so no limit on it separates the two.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .reference import ipm


def _rows(M, V):
    """``V @ M.T`` in float64 for a dense or scipy M."""
    return np.asarray((M @ V.T).T) if sp.issparse(M) else V @ M.T


def _dense(M, device):
    M = M.toarray() if sp.issparse(M) else np.asarray(M)
    return torch.as_tensor(M, dtype=torch.float64, device=device)


def recompute(P, A, q, l, u, x, y, eps_abs, eps_rel):
    """Per answer (rows of x and y), in float64: ``(ratio, obj, obj_scale,
    dres, dres_scale)``: the termination test's ratio, the objective and the
    size of its terms, the dual residual and the size of its terms."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    Px, Ax, Aty = _rows(P, x), _rows(A, x), _rows(A.T, y)
    proj = np.clip(Ax, l, u)

    def nrm(V):
        return np.abs(V).max(axis=1)

    pri = nrm(Ax - proj)
    dres = nrm(Px + q + Aty)
    eps_pri = eps_abs + eps_rel * np.maximum(nrm(Ax), nrm(proj))
    dres_scale = np.maximum(np.maximum(nrm(Px), nrm(Aty)), nrm(q))
    eps_dua = eps_abs + eps_rel * dres_scale
    ratio = np.maximum(pri / eps_pri, dres / eps_dua)
    xPx = 0.5 * np.einsum('bi,bi->b', x, Px)
    qx = np.einsum('bi,bi->b', q, x)
    return ratio, xPx + qx, np.abs(xPx) + np.abs(qx), dres, dres_scale


def judge(client, cfg, samples, seed, sample_instances, device):
    """Compare the sampled answers with the reference.  ``samples``: a list
    of ``(record, answers)`` (``record`` from ``client.record()``,
    ``answers`` the system's per-instance arrays).  Returns ``(checks,
    readings)``: checks ``{name: {'value', 'limit'}}`` and readings not
    compared."""
    st = cfg['system']['settings']
    eps_abs, eps_rel = float(st['eps_abs']), float(st['eps_rel'])
    rng = np.random.default_rng([seed, 2])
    P_t, A_t = _dense(client.P, device), _dense(client.A, device)
    mismatch = judged = 0
    worst_ratio = worst_claim = worst_x = 0.0
    ref_iters = 0
    for rec, ans in samples:
        B = len(ans['status'])
        rows = np.sort(rng.choice(B, size=min(sample_instances, B), replace=False))
        q, l, u = client.expand(rec, rows if B > 1 else None)
        ref = ipm.solve(P_t, A_t, *(torch.as_tensor(v, dtype=torch.float64, device=device)
                                    for v in (q, l, u)))
        ref_status = ref.status.cpu().numpy()
        x, y = ans['x'][rows], ans['y'][rows]
        status = ans['status'][rows]
        ratio, obj, obj_scale, dres, dres_scale = recompute(client.P, client.A, q, l, u, x, y,
                                                            eps_abs, eps_rel)
        gap = np.maximum(np.abs(ans['obj_val'][rows] - obj) / obj_scale,
                         np.abs(ans['dual_res'][rows] - dres) / dres_scale)
        x_ref = ref.x.cpu().numpy()
        xg = np.abs(x - x_ref).max(axis=1) / (1 + np.abs(x_ref).max(axis=1))
        solved = status == ipm.SOLVED
        mismatch += int((status != ref_status).sum())
        judged += len(rows)
        worst_ratio = max(worst_ratio, _worst(ratio[solved]))
        worst_claim = max(worst_claim, _worst(gap))
        worst_x = max(worst_x, _worst(xg))
        ref_iters = max(ref_iters, int(ref.iters.max()))
        del ref
    lim = cfg['limits']
    checks = {
        'status_mismatch': dict(value=mismatch, limit=lim['status_mismatch']),
        'term_ratio': dict(value=worst_ratio, limit=lim['term_ratio']),
        'claim_gap': dict(value=worst_claim, limit=lim['claim_gap']),
    }
    readings = dict(answers_judged=judged, x_gap=worst_x, reference_newton_steps=ref_iters)
    return checks, readings


def _worst(v) -> float:
    v = np.asarray(v, np.float64)
    if not v.size:
        return 0.0
    return float('inf') if not np.isfinite(v).all() else float(v.max())


def passed(checks) -> bool:
    return all(c['limit'] is not None and c['value'] <= c['limit'] for c in checks.values())
