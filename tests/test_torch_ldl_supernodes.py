"""The supernodal layout and schedules of the port's sparse LDL'
(osqp_tpu_torch.ops.ldl.symbolic) on the CPU: the partition into
supernodes and thin columns, the relative row maps, K5's launch plan and
K6's task order (both topological), the panels read in place in Lx, and
K5's launch count.  No JAX: the patterns come from chip_smoke.py's
generators and seeded numpy."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from chip_smoke import banded_qp, kkt_triu, portfolio_family
from osqp_tpu_torch.ops import ldl as tldl


def _kkt(prob):
    return kkt_triu(prob[0], prob[2])


def _dense(n=150):
    rng = np.random.default_rng(4)
    M = rng.standard_normal((n, n))
    return sp.triu(sp.csc_matrix(M @ M.T / n + np.eye(n)), format='csc')


def _ragged(seed=0, n=300, m=200, density=0.02):
    rng = np.random.default_rng(seed)
    L = sp.random(n, n, density=density, random_state=rng)
    P = (L @ L.T + 0.1 * sp.eye(n)).tocsc()
    A = sp.random(m, n, density=density, random_state=rng).tocsc()
    return kkt_triu(P, A)


def _edges(sizes=(31, 32, 33, 63, 64, 65, 129)):
    """Dense blocks around SUPERNODE_MIN and TILE."""
    rng = np.random.default_rng(0)
    blocks = []
    for b in sizes:
        M = rng.standard_normal((b, b))
        blocks.append(sp.csc_matrix(M @ M.T / b + np.eye(b)))
    return sp.triu(sp.block_diag(blocks, format='csc'), format='csc')


PATTERNS = {
    'portfolio_2000x20': lambda: _kkt(portfolio_family(2000, 20)),
    'portfolio_400x10': lambda: _kkt(portfolio_family(400, 10)),
    'dense': _dense,
    'chain': lambda: _kkt(banded_qp(1024)),
    'ragged': _ragged,
    'supernode_edges': _edges,
}
_cache = {}


def _sym(name):
    if name not in _cache:
        _cache[name] = tldl.symbolic(PATTERNS[name]())
    return _cache[name]


def _rows(sym, s):
    _, _, nrows, off = sym.sn[s]
    return sym.sn_rows[off:off + nrows]


def _panel_entries(sym, s):
    """Supernode s's entries below its diagonal as the kernels address them
    in place in Lx: row position p, column c, index Lp[j0 + c] - c - 1 + p."""
    j0, w, nrows, _ = (int(v) for v in sym.sn[s])
    c = np.repeat(np.arange(w), nrows - 1 - np.arange(w))
    p = np.concatenate([np.arange(k + 1, nrows) for k in range(w)]).astype(np.int64)
    return p, c, sym.Lp[j0 + c].astype(np.int64) - c - 1 + p


def _nested(sym, j):
    """Column j's rows are j + 1 and column j + 1's rows."""
    Lnz = np.diff(sym.Lp)
    return j + 1 < sym.n and sym.parent[j] == j + 1 and Lnz[j] == Lnz[j + 1] + 1


@pytest.mark.parametrize('name', list(PATTERNS))
def test_partition(name):
    """Each supernode's columns nest as the rule says, each is maximal and
    at least SUPERNODE_MIN wide, its row list is its columns then the rows
    below, sorted, and every column lies in one supernode or is thin; a
    run of nested thin columns is narrower than SUPERNODE_MIN."""
    sym = _sym(name)
    n = sym.n
    owner = np.full(n, -1)
    for s, (j0, w, nrows, _) in enumerate(sym.sn):
        assert w >= tldl.SUPERNODE_MIN
        assert all(_nested(sym, j) for j in range(j0, j0 + w - 1))
        assert not (j0 > 0 and _nested(sym, j0 - 1)) and not _nested(sym, j0 + w - 1)
        rows = _rows(sym, s)
        last = j0 + w - 1
        want = np.r_[np.arange(j0, j0 + w), sym.Li[sym.Lp[last]:sym.Lp[last + 1]]]
        np.testing.assert_array_equal(rows, want)
        np.testing.assert_array_equal(rows[1:], sym.Li[sym.Lp[j0]:sym.Lp[j0 + 1]])
        assert np.all(np.diff(rows) > 0) and nrows == len(rows)
        assert np.all(owner[j0:j0 + w] == -1)
        owner[j0:j0 + w] = s
    np.testing.assert_array_equal(sym.snode, owner)
    run = 0
    for j in range(n):
        run = run + 1 if owner[j] < 0 else 0
        if owner[j] < 0 and not _nested(sym, j):
            assert run < tldl.SUPERNODE_MIN, (j, run)
            run = 0
    expect = {'dense': [150], 'chain': [], 'portfolio_2000x20': [73, 137, 255, 508, 958],
              'supernode_edges': [32, 33, 63, 64, 65, 129]}
    if name in expect:
        assert sym.sn[:, 1].tolist() == expect[name]


@pytest.mark.parametrize('name', list(PATTERNS))
def test_relative_row_maps(name):
    """Each supernode pair's map gives its rows' positions in the target's
    row list (brute-force search); every source's rows lie in the target's
    rows from its first row in the target's columns on; every source that
    meets a target's columns is there once; and every thin entry in a
    supernode column is a one-entry pivot update (Tone) or lies in a thin
    source of that supernode."""
    sym = _sym(name)
    for s, (j0, w, _, _) in enumerate(sym.sn):
        where = {r: p for p, r in enumerate(_rows(sym, s))}  # each row's position
        srcs = []
        for t, a, cnt, off in sym.pairs[sym.pair_ptr[s]:sym.pair_ptr[s + 1]]:
            rows_t = _rows(sym, t)
            assert a + cnt == len(rows_t) and t < s
            srcs.append(('sup', t, rows_t[a:], off, rows_t[a - 1]))
        for k, f, cnt, _ in sym.gsrc[sym.gsrc_ptr[s]:sym.gsrc_ptr[s + 1]]:
            assert sym.snode[k] < 0 and f + cnt == sym.Lp[k + 1] and cnt >= 2
            prev = sym.Li[f - 1] if f > sym.Lp[k] else -1
            srcs.append(('thin', k, sym.Li[f:f + cnt], None, prev))
        for _, _, rows, off, prev in srcs:
            assert all(r in where for r in rows)  # every row lies in s's rows
            if off is not None:  # a supernode's map (K5 places a thin one's by search)
                np.testing.assert_array_equal(sym.relmap[off:off + len(rows)],
                                              [where[r] for r in rows])
            assert j0 <= rows[0] < j0 + w and prev < j0
        # every supernode and thin column with rows in s's columns
        want_sup = sorted(t for t in range(s) if np.any(
            (_rows(sym, t) >= j0) & (_rows(sym, t) < j0 + w)))
        assert sorted(x[1] for x in srcs if x[0] == 'sup') == want_sup
        cols = np.repeat(np.arange(sym.n), np.diff(sym.Lp))
        hit = (sym.Li >= j0) & (sym.Li < j0 + w) & (sym.snode[cols] < 0)
        thin_k = np.unique(cols[hit])
        big = {x[1] for x in srcs if x[0] == 'thin'}
        for k in thin_k:
            entries = sym.Li[sym.Lp[k]:sym.Lp[k + 1]]
            first = np.flatnonzero(entries >= j0)[0]
            if len(entries) - first >= 2:
                assert k in big
            else:
                row = entries[first]
                e = np.flatnonzero(sym.Tk[sym.Tp[row]:sym.Tp[row + 1]] == k)[0] + sym.Tp[row]
                assert sym.Tone[e] == 1 and k not in big
    # the thin-entry table: by row, every thin entry whose row is a
    # supernode column
    cols = np.repeat(np.arange(sym.n), np.diff(sym.Lp))
    sel = (sym.snode[cols] < 0) & (sym.snode[sym.Li] >= 0)
    got = sorted(zip(np.repeat(np.arange(sym.n), np.diff(sym.Tp)), sym.Tk, sym.Tc))
    want = sorted(zip(sym.Li[sel], cols[sel], sym.csc2csr[sel]))
    assert got == want


def _column_op(sym):
    """The plan op (and position inside a chain) of each column."""
    op = np.full(sym.n, -1)
    order = np.zeros(sym.n)
    for o, (kind, a, b) in enumerate(sym.plan):
        if kind == 2:
            j0, w = sym.sn[a, :2]
            op[j0:j0 + w] = o
        else:
            cols = sym.items[a:a + b, 0]
            op[cols] = o
            order[cols] = np.arange(a, a + b)
    return op, order


@pytest.mark.parametrize('name', list(PATTERNS))
def test_k5_plan_topological(name):
    """K5's plan holds every column once; each column's sources (its row's
    entries) come in an earlier op, in the same supernode, or earlier in
    the same chain; a level's columns are independent; chains are
    maximal: a level op of one item only stands beside a supernode."""
    sym = _sym(name)
    op, order = _column_op(sym)
    assert np.all(op >= 0)
    thin = sym.snode < 0
    assert sorted(sym.items[sym.items[:, 1] == 0, 0].tolist()) == np.flatnonzero(thin).tolist()
    cols = np.repeat(np.arange(sym.n), np.diff(sym.Lp))  # entry (Li, cols): col updates Li
    src, dst = cols, sym.Li
    same = op[src] == op[dst]
    assert np.all(op[src] <= op[dst])
    kinds = sym.plan[op[dst], 0]
    ok_same = (kinds == 2) | ((kinds == 1) & (order[src] < order[dst]))
    assert np.all(ok_same[same])
    for o in range(len(sym.plan) - 1):
        assert not (sym.plan[o, 0] == 1 and sym.plan[o + 1, 0] == 1)
        if sym.plan[o, 0] == 0 and sym.plan[o, 2] == 1:
            assert sym.plan[o + 1, 0] == 2
    if name == 'chain':  # the banded KKT: a chain of short columns, one launch
        assert sym.k5_launches <= 3 < sym.depth


def _task_of(sym):
    """Ticket of the task that computes each y (forward) and x (backward),
    and the warp inside a thin group."""
    fwd, bwd = np.full(sym.n, -1), np.full(sym.n, -1)
    warp_f, warp_b = np.zeros(sym.n), np.zeros(sym.n)
    for t, (kind, a, b, _) in enumerate(sym.k6_tasks):
        if kind == 0:
            fwd[a:a + b], warp_f[a:a + b] = t, np.arange(b)
        elif kind == 2:
            bwd[a - b + 1:a + 1], warp_b[a - b + 1:a + 1] = t, np.arange(b)[::-1]
        else:
            j0, w = sym.sn[a, :2]
            lo, hi = j0 + tldl.TILE * b, min(j0 + w, j0 + tldl.TILE * (b + 1))
            (fwd if kind == 1 else bwd)[lo:hi] = t
    return fwd, bwd, warp_f, warp_b


@pytest.mark.parametrize('name', list(PATTERNS))
def test_k6_tasks_topological(name):
    """K6's tickets: every value computed once; forward before backward;
    each value's sources in an earlier ticket, in the same tile, or in a
    lower warp of the same thin group; each forward tile's sources are the
    supernodes whose rows meet its rows (their row positions there), then
    the supernode itself up to the tile."""
    sym = _sym(name)
    fwd, bwd, wf, wb = _task_of(sym)
    assert np.all(fwd >= 0) and np.all(bwd >= 0) and fwd.max() < bwd.min()
    assert len(sym.k6_tasks) == bwd.max() + 1
    cols = np.repeat(np.arange(sym.n), np.diff(sym.Lp))
    i, k = sym.Li, cols  # y_i needs y_k; x_k needs x_i
    for dep, use, tk, warp in ((k, i, fwd, wf), (i, k, bwd, wb)):
        earlier = tk[dep] < tk[use]
        same = tk[dep] == tk[use]
        tile = sym.k6_tasks[tk[use], 0] % 2 == 1
        assert np.all(earlier | (same & (tile | (warp[dep] < warp[use]))))
    T = tldl.TILE
    for t_id, (kind, s, r, first) in enumerate(sym.k6_tasks):
        if kind != 1:
            continue
        j0, w = sym.sn[s, :2]
        R0, R1 = j0 + T * r, min(j0 + w, j0 + T * (r + 1))
        want = []
        for t in range(s):
            pos = np.flatnonzero((_rows(sym, t) >= R0) & (_rows(sym, t) < R1))
            if len(pos):
                want.append((t, pos[0], pos[-1] + 1))
                assert pos[-1] - pos[0] + 1 == len(pos)
        want.append((s, T * r, R1 - j0))
        got = []
        e = first
        while sym.k6_src[e, 0] >= 0:
            got.append(tuple(int(v) for v in sym.k6_src[e, :3]))
            e += 1
        assert got == want


@pytest.mark.parametrize('name', list(PATTERNS))
def test_panel_round_trip(name):
    """The plain factor's Lx scattered into dense panels (L below the
    diagonal, D on it) and read back is equal bit for bit, and each panel
    is the dense L at its rows and columns."""
    sym = _sym(name)
    fac = tldl.LDLFactor(PATTERNS[name](), device='cpu')
    assert fac.sym.sn.tolist() == sym.sn.tolist()
    Lx, D, Ld = fac.Lx.numpy()[:sym.nnz_L], fac.D.numpy(), fac._L_dense.numpy()
    back = np.full_like(Lx, np.nan)
    back[sym.snode[np.repeat(np.arange(sym.n), np.diff(sym.Lp))] < 0] = \
        Lx[sym.snode[np.repeat(np.arange(sym.n), np.diff(sym.Lp))] < 0]
    for s, (j0, w, nrows, _) in enumerate(sym.sn):
        p, c, q = _panel_entries(sym, s)
        panel = np.zeros((nrows, w))
        panel[p, c] = Lx[q]
        panel[np.arange(w), np.arange(w)] = D[j0:j0 + w]
        rows = _rows(sym, s)
        want = np.tril(Ld[np.ix_(rows, np.arange(j0, j0 + w))], -1)
        want[np.arange(w), np.arange(w)] = D[j0:j0 + w]
        assert np.array_equal(panel, want)
        back[q] = panel[p, c]
    assert np.array_equal(back, Lx)
    x = fac.solve(torch.ones(sym.n, dtype=torch.float64))
    assert torch.isfinite(x).all()


def _launches_by_hand(sym):
    count = 0
    for kind, a, _ in sym.plan:
        if kind != 2:
            count += 1
            continue
        w, nrows = int(sym.sn[a, 1]), int(sym.sn[a, 2])
        sources = sym.pair_ptr[a + 1] > sym.pair_ptr[a]
        gathered = sym.gsrc_ptr[a + 1] > sym.gsrc_ptr[a]
        c0s = range(0, w, tldl.TILE)
        # start, gather, update by the sources; per panel its diagonal
        # block, its rows below where there are any, and a trailing update
        # but after the last
        below = sum(nrows > c0 + min(tldl.TILE, w - c0) for c0 in c0s)
        count += 1 + gathered + (sources or gathered) + len(c0s) + below + (len(c0s) - 1)
    return count


@pytest.mark.parametrize('name', list(PATTERNS))
def test_k5_launches(name):
    """Symbolic.k5_launches against a count made from the plan; and known
    counts: a dense 150 x 150 matrix (one supernode, three panels: its
    start, three diagonal blocks, two launches of rows below and two
    trailing updates) and the banded chain (one launch for the chain and one for the
    level of two leaves, far below its depth)."""
    sym = _sym(name)
    assert sym.k5_launches == _launches_by_hand(sym)
    if name == 'dense':
        assert sym.k5_launches == 8
    if name == 'chain':
        assert sym.k5_launches == 2 and sym.depth > 2000
