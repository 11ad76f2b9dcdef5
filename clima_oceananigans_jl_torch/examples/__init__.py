"""The port's copies of the JAX package's example scripts, each run with
``python -m clima_oceananigans_jl_torch.examples.<name>``."""
