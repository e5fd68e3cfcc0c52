"""The card's bound model: the least time an H100 could take for a piece
of work, from its published peaks.

``chip_smoke.py`` states each kernel's time beside this bound, and the
``roofline`` driver (``cli/evaluation/roofline.py``) reads the PQ ADC
scan against it. The bound is the largest of three times: the bytes the
work must move through HBM (each input read once, each output written
once) over the HBM rate, the bytes its LUT lookups read from shared
memory over the shared-memory rate, and its operations over the peak rate
of their type.
"""

from __future__ import annotations

import subprocess

#: The H100 SXM's published peaks (NVIDIA's data sheet, dense rates at
#: 700 W): HBM3 bytes/s, and operations/s of the bf16 and int8 tensor
#: cores and of the float32 CUDA cores. The ADC lookups (float or int32
#: adds) and the budget exact kernels' products run on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
#: Shared memory delivers 128 bytes per clock on each SM (32 banks of 4
#: bytes); its rate is that times the SMs times the card's max SM clock.
SMEM_BYTES_PER_CLOCK = 128


def smem_bytes_per_s(max_sm_mhz: float | None = None,
                     sms: int | None = None) -> float:
    """The card's shared-memory rate: :data:`SMEM_BYTES_PER_CLOCK` on each
    of ``sms`` SMs at ``max_sm_mhz``. Unset, they are read from the card:
    ``nvidia-smi --query-gpu=clocks.max.sm`` and device 0's SM count."""
    if max_sm_mhz is None:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True,
                             timeout=60)
        max_sm_mhz = float(out.stdout.split()[0])
    if sms is None:
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SMEM_BYTES_PER_CLOCK * sms * max_sm_mhz * 1e6


def bound(nbytes: float, ops: float, kind: str, shared: float = 0.0,
          shared_rate: float = 1.0) -> tuple[float, str, str]:
    """The least time in ms the card could take: the largest of ``nbytes``
    over the HBM rate, the ``shared`` bytes (the ADC kernels' LUT lookups)
    over ``shared_rate``, and ``ops`` over the peak rate of ``kind``
    ("bf16", "int8" or "fp32"). → (ms, "bytes" or "operations", the term
    that set it: "hbm", "shared" or "operations")."""
    times = {"hbm": nbytes / HBM_BYTES_PER_S, "shared": shared / shared_rate,
             "operations": ops / PEAK_OPS[kind]}
    term = max(times, key=times.get)
    return (times[term] * 1e3,
            "operations" if term == "operations" else "bytes", term)
