"""PyTorch and CUDA port of the split-learning system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports none of
it (and never ``jax``).  Layout mirrors the reference module by module.
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where each kernel's plain PyTorch version runs.
"""
import torch

# Plain f32 matrix products stay full f32 on the card, as the reference
# computes them; TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the card (raises without one); "cpu" only when
    asked for.  Entry points never carry on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return dev
