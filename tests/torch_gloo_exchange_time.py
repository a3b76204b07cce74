"""Time one exchange of a mesh over two gloo processes of this host.

    python tests/torch_gloo_exchange_time.py [--device cuda:0] [--reps 20]

starts two processes (children of this script, sharing the device) that
time, for a block of two rows of 1, 2^18 and 2^20 float64 each (a process's
two shards of a 0-d psum, of bigqp's P v gather, of its A' rho A v psum at
n = 2^20): ``Transport.gather`` (the mesh's exchange, host copies included
on a card), and on pinned host buffers gloo's ``all_gather`` and one
``broadcast`` a rank, all posted before the first wait.  Rank 0 prints one line per case, in milliseconds a
call, after the card's name and power limit.  Nothing here imports JAX.
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from osqp_tpu_torch.parallel import distributed  # noqa: E402


def _ms(fn, reps, device):
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def child(rank, init, device, reps):
    distributed.initialize('gloo', init_method=init, rank=rank, world_size=2, timeout_s=120)
    try:
        device = torch.device(device)
        tr = distributed.Transport(dist.group.WORLD, device)
        pin = device.type == 'cuda'
        for n in (1, 1 << 18, 1 << 20):
            t = torch.randn(2, n, dtype=torch.float64, device=device)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t)
            out = torch.empty((2, *t.shape), dtype=t.dtype, pin_memory=pin)

            def broadcasts():
                out[rank].copy_(host)
                for w in [dist.broadcast(out[r], r, async_op=True) for r in range(2)]:
                    w.wait()

            row = dict(
                gather=_ms(lambda: tr.gather(t), reps, device),
                all_gather_host=_ms(lambda: dist.all_gather(list(out.unbind(0)), host), reps,
                                    device),
                broadcasts_host=_ms(broadcasts, reps, device))
            if rank == 0:
                print(f'2 x {n} float64 a process ({t.numel() * 8} bytes): ' + ', '.join(
                    f'{k} {v:.3f} ms' for k, v in row.items()), flush=True)
    finally:
        distributed.shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda:0')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--rank', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--init', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return child(args.rank, args.init, args.device, args.reps)
    if args.device.startswith('cuda'):
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip())
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:  # the FileStore's file
        cmd = [sys.executable, __file__, '--device', args.device, '--reps', str(args.reps),
               '--init', f'file://{tmp}/store']
        procs = [subprocess.Popen(cmd + ['--rank', str(r)]) for r in range(2)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f'a child failed: {codes}')


if __name__ == '__main__':
    main()
