from rtgs_tpu.ops.peel import peel_keys

__all__ = ["peel_keys"]
