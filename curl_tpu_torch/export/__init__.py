"""Weight conversion from the JAX package's variables."""

from curl_tpu_torch.export.torch_convert import state_dict_from_jax, strip_ddp_prefix

__all__ = ["state_dict_from_jax", "strip_ddp_prefix"]
