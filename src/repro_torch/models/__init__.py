"""Model zoo: composable PyTorch blocks covering the 10 architectures of
``repro_torch.configs``, in ``repro.models``' parameter trees."""
from . import attention, layers, mamba2, model, moe, rwkv6, transformer  # noqa: F401
