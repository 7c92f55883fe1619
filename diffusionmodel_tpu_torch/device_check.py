"""Device resolution and an environment report (counterpart of
``diffusionmodel_tpu/device_check.py``).

    python -m diffusionmodel_tpu_torch.device_check

Every entry point of the port resolves its device here: the default is the
GPU, and a missing GPU is an error unless the caller asked for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for (or
    defaulted to) and absent: the port never falls back to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def main() -> None:
    print(f"torch version: {torch.__version__}")
    print(f"CUDA build: {torch.version.cuda}")
    print(f"CUDA available: {torch.cuda.is_available()}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"Device count: {n}")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i} {p.name} (sm_{p.major}{p.minor}, "
              f"{p.total_memory / 2**30:.1f} GiB, "
              f"{p.multi_processor_count} SMs)")
    print(f"cudnn.allow_tf32: {torch.backends.cudnn.allow_tf32}")
    print(f"cuda.matmul.allow_tf32: {torch.backends.cuda.matmul.allow_tf32}")


if __name__ == "__main__":
    main()
