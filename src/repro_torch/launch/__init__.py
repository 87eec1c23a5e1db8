"""Launch layer of the port: the serving CLI (``serve``) and the training
CLI (``train``).  JAX's mesh / shapes / roofline / dry-run tooling is not
ported yet."""
