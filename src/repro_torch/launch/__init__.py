"""Launch layer of the port: the serving CLI (``serve``), the training
CLI (``train``), the assigned input shapes (``shapes``: meta-tensor
stand-ins for every --arch x shape id), device meshes (``mesh``: explicit
arrays of ``torch.device``, simulated where the caller passes the devices)
and one card's roofline terms (``roofline``: the H100's rates, op-by-op
flops and bytes counted under a dispatch mode).  JAX's HLO collective
parsing and dry-run tooling are not ported yet."""
