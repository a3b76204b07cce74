"""Published peak rates of the cards the benchmark may run on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit), keyed by a
part of the name that ``torch.cuda.get_device_name`` gives.  A copy of the
repository's ``chip_smoke.PEAKS``, kept here so that the yardstick does not
move with it."""

from __future__ import annotations

# name: (fp32 FLOP/s on the CUDA cores, fp64 FLOP/s with DMMA, memory bytes/s,
# bf16 FLOP/s on the tensor cores)
PEAKS = {
    'H100 PCIe': (51.2e12, 51.2e12, 2.0e12, 756e12),
    'H100 NVL': (60e12, 60e12, 3.9e12, 835e12),
    'H100': (67e12, 67e12, 3.35e12, 989e12),  # SXM5
}


def card(name: str) -> dict:
    """The peaks of the card called ``name`` (the first key it contains)."""
    for key, (fp32, fp64, bw, bf16) in PEAKS.items():
        if key in name:
            return dict(name=name, fp32=fp32, fp64=fp64, bytes_per_s=bw, bf16=bf16)
    raise RuntimeError(f'no peak rates known for {name!r}')
