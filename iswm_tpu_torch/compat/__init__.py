from .bridge import load_checkpoint, load_momentum, momentum_from_optax, state_dict_from_jax

__all__ = ["load_checkpoint", "load_momentum", "momentum_from_optax", "state_dict_from_jax"]
