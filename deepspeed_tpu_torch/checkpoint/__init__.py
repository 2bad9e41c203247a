from .ds_native import DeepSpeedNativeCheckpoint, load_ds_checkpoint_into

__all__ = ["DeepSpeedNativeCheckpoint", "load_ds_checkpoint_into"]
