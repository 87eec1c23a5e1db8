"""Launch layer of the port: so far the serving CLI (``serve``), U-Net
paths only.  JAX's mesh / shapes / roofline / train / dry-run tooling is
not ported yet."""
