from .from_flax import from_flax, load_flax
