"""PyTorch and CUDA port of `repro`, for an NVIDIA H100.

Module paths mirror `repro`'s (`repro_torch.fl.runtime` is the
counterpart of `repro.fl.runtime`). The package imports torch and numpy:
never jax, networkx or `repro`. Its entry points run on
the card unless the caller passes ``device="cpu"``.
"""
