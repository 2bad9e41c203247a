from .cuda_accelerator import gpu_name_and_power_limit, resolve_device

__all__ = ["gpu_name_and_power_limit", "resolve_device"]
