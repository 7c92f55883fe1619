"""Device resolution and an environment report (counterpart of
``diffusionmodel_tpu/device_check.py``).

    python -m diffusionmodel_tpu_torch.device_check

Every entry point of the port resolves its device here: the default is the
GPU, and a missing GPU is an error unless the caller asked for the CPU.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fp32_compute(device: torch.device, autotune: bool = True,
                 deterministic: bool = False):
    """The port's fp32 settings inside the block on a CUDA device,
    restored after it: TF32 off in cuDNN and cuBLAS (PyTorch's default
    leaves it on for cuDNN convolutions), cuDNN autotuning on unless
    ``autotune`` is false, and cuDNN held to its deterministic algorithms
    when ``deterministic`` is true. With the default heuristics, cuDNN
    takes an FFT algorithm for some of the flagship's fp32 shapes (the
    192-channel 3x3 convolutions at 128 px, batch 4 or 20) that is ~60x
    slower than the one it takes at batch 16; the search costs about two
    minutes of the first train step (NVIDIA H100;
    tools/flagship_train_probe.py).

    ``trainer.fit`` and ``sample.gen_samples`` (``--mode train|generate``)
    run under it for the call, ``SamplerService``'s worker thread for the
    service's lifetime; ``LdmRunner``'s txt2img / img2img / inpaint and
    ``ImageMetrics``' feature extraction run under it without autotuning
    (the search costs more than it saves there). A textbook-family
    service asks for ``deterministic``: cuDNN's default choice for the
    labml net gave an eval output that did not repeat bit for bit on the
    card, and a pinned request must. The flags are process
    settings: another thread's CUDA work in the block runs under them
    too."""
    if device.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
              cudnn.deterministic)
    cudnn.allow_tf32, matmul.allow_tf32 = False, False
    cudnn.benchmark = autotune
    cudnn.deterministic = deterministic or cudnn.deterministic
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
         cudnn.deterministic) = before


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
