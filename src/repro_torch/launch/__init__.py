"""Launch layer of the port: the serving CLI (``serve``), the training
CLI (``train``), the assigned input shapes (``shapes``: meta-tensor
stand-ins for every --arch x shape id) and one card's roofline terms
(``roofline``: the H100's rates, op-by-op flops and bytes counted under a
dispatch mode).  JAX's mesh, HLO collective parsing and dry-run tooling
need a second GPU or XLA and are not ported."""
