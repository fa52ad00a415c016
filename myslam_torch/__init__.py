"""myslam_torch: dense RGB-D SLAM in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of ``myslam_tpu``: the same tri-plane SDF
scene representation, tracking and mapping loops, written eagerly in
PyTorch for one NVIDIA Hopper GPU.  The tri-plane sample's forward and
backward run as CUDA kernels (``csrc/plane_sample.cu``); every other
operation is plain PyTorch.

Device policy:
  * entry points run on the GPU; the CPU is used only when the caller
    passes ``device="cpu"`` (the tests do);
  * float32 matmuls and convolutions run in full float32: TF32 is off,
    as the JAX package pins ``jax_default_matmul_precision=float32``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The GPU; raises when none is visible (the CPU must be asked for)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "myslam_torch runs on a CUDA device and none is visible; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the GPU when it is None."""
    return default_device() if device is None else torch.device(device)
