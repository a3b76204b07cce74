"""K1's iteration time with its termination check inlined or out of line.

Times K1 (``osqp_tpu_torch/ops/shared_epoch.py::shared_epoch``) at the
batched-MPC headline (B=4096, n=32, m=48, float32; ``chip_smoke.py``'s
``epoch_inputs``) in each mode at K = 0 and 25, and 'highest' also at K = 50,
for several builds of ``csrc/shared_epoch.cu``, each in a process of its
own: the tree as checked in; the same with ``check_phase`` out of line
(``__noinline__``); and, with ``--parent DIR``, another checkout (for
example the parent commit unpacked by ``git archive``).  For each build it
also prints the size and instruction mix of the 'highest' float32 kernel's
iteration loop from its SASS (``cuobjdump``).  Not a test (pytest does not
collect it); it needs one NVIDIA GPU and the CUDA toolkit.  Run from the
repository root:

    python tests/torch_k1_check_inline.py [--parent DIR] [--rounds 2]

The copies are made under ``build/k1_inline/``.
"""

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / 'build' / 'k1_inline'
KERNEL = 'shared_epoch_kernelIfLi2ELi0E'  # 'highest', float32, TC = 2

CHILD = r'''
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from osqp_tpu_torch.ops import _build, shared_epoch as se
lib = _build.build('shared_epoch')
fixed, state, sc, ctx = cs.epoch_inputs(4096, 32, 48, torch.float32, 0)
out = dict(lib=str(lib))
for prec, Ks in (('highest', (0, 25, 50)), ('high', (0, 25)), ('default', (0, 25))):
    for K in Ks:
        sck = sc._replace(K=K, iter_prec=prec)
        out[f'{prec}_K{K}'] = cs.device_ms(lambda: se.shared_epoch(*fixed, *state, sck), 50,
                                           name='shared_epoch_kernel')
print('RESULT', json.dumps(out), flush=True)
'''


def copy_tree(src: Path, dst: Path, noinline: bool = False):
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(src / 'osqp_tpu_torch', dst / 'osqp_tpu_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(src / 'chip_smoke.py', dst / 'chip_smoke.py')
    if noinline:
        cu = dst / 'osqp_tpu_torch' / 'ops' / 'csrc' / 'shared_epoch.cu'
        text = cu.read_text()
        old = '__device__ __forceinline__ void check_phase('
        if old not in text:
            raise RuntimeError('check_phase is not declared as expected')
        cu.write_text(text.replace(old, '__device__ __noinline__ void check_phase('))


def iteration_loop(lib: str) -> dict:
    """The 'highest' f32 kernel's iteration loop in SASS: the first
    backward branch (by address) whose body holds a barrier, FFMA (the
    product) and FSETP (the projection onto [l, u]); the check follows it."""
    sass = subprocess.run(['/usr/local/cuda/bin/cuobjdump', '-sass', lib], capture_output=True,
                          text=True, check=True).stdout
    ins, on = [], False
    for line in sass.splitlines():
        if 'Function :' in line:
            on = KERNEL in line
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?);', line) if on else None
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    best = None
    for addr, text in ins:
        m = re.search(r'BRA.*?(0x[0-9a-f]+)', text)
        if not m or int(m.group(1), 16) > addr:
            continue
        body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
        ops = collections.Counter(re.sub(r'^@!?U?P\w+\s+', '', t).split()[0].split('.')[0]
                                  for t in body)
        start = int(m.group(1), 16)
        if ops['BAR'] and ops['FFMA'] and ops['FSETP'] and (best is None
                                                          or start < int(best['start'], 16)):
            best = dict(instructions=len(body), start=hex(start),
                        mix=dict(ops.most_common(8)))
    return dict(kernel_instructions=len(ins), loop=best)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', type=Path, help='another checkout to time beside this one')
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args(argv)
    builds = {'tree': (ROOT, False), 'check_noinline': (ROOT, True)}
    if args.parent:
        builds['parent'] = (args.parent.resolve(), False)
    for name, (src, noinline) in builds.items():
        copy_tree(src, WORK / name, noinline)
    for rnd in range(args.rounds):
        for name in builds:
            p = subprocess.run([sys.executable, '-c', CHILD], cwd=WORK / name,
                               capture_output=True, text=True)
            res = [ln for ln in p.stdout.splitlines() if ln.startswith('RESULT')]
            if not res:
                print(f'k1 inline {name}: failed\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}')
                return 1
            row = dict(build=name, round=rnd, **json.loads(res[0][7:]))
            row['highest_us_per_iter_0_25'] = (row['highest_K25'] - row['highest_K0']) / 25 * 1e3
            row['highest_us_per_iter_25_50'] = (row['highest_K50'] - row['highest_K25']) / 25 * 1e3
            if rnd == 0:
                row['sass'] = iteration_loop(row['lib'])
            print('k1 inline:', json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
