"""The JAX package's ``examples/`` on the port, one module each, run as
``python -m repro_torch.examples.<name>``: ``quickstart``,
``interpolation`` (§5.3), ``reconstruction`` (§5.4, Table 2),
``discrete_ddim`` (App. A), ``lm_diffusion`` and ``gateway_sse``.

Each takes the JAX example's flags plus ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain versions), prints the JAX
example's lines (the port's reference backend is ``eager`` where JAX's
is ``jnp``), and its ``main(argv)`` returns what it printed as a dict.
"""
