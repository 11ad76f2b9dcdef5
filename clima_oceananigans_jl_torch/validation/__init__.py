"""The port's copies of the JAX package's validation scripts, each run
with ``python -m clima_oceananigans_jl_torch.validation.<name>``."""
