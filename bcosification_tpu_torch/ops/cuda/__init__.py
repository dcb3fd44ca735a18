"""Hand-written Hopper kernels (CUDA C++ for sm_90a, built with nvcc on
first use and bound through ctypes), their ``torch.library`` custom ops
(namespace ``bcos_torch``, registered when this package is imported) and
their launch counters."""
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain, conv1x1_fwd
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd
from bcosification_tpu_torch.ops.cuda.stream import stream_add

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

# kernel name -> the wrapper that launches it and counts its launches
KERNELS = {
    "bcos_conv1x1_fwd": conv1x1_fwd,
    "bcos_conv1x1_bwd_explain": conv1x1_bwd_explain,
    "bcos_matmul_fwd": bcos_matmul_fwd,
    "stream_add": stream_add,
}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}
