"""Hand-written CUDA kernels (csrc/*.cu) with their plain PyTorch
versions.  Importing this package builds nothing: the kernels are built
with nvcc at their first launch (ops/_build.py)."""
from sejonggo_torch.ops.errors import check_kernel_errors
from sejonggo_torch.ops.flood import flood_fixpoint, flood_plain
from sejonggo_torch.ops.gostep import step_legal, step_legal_plain


def kernel_launches() -> dict:
    """Launch counts of every kernel wrapper, by kernel name."""
    return {"gostep": step_legal.launches, "flood": flood_fixpoint.launches}


def reset_kernel_launches() -> None:
    step_legal.launches = 0
    flood_fixpoint.launches = 0
