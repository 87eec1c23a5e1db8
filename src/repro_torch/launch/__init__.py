"""Launch layer of the port: the serving CLI (``serve``), the training
CLI (``train``), the assigned input shapes (``shapes``: meta-tensor
stand-ins for every --arch x shape id), device meshes (``mesh``: explicit
arrays of ``torch.device``, simulated where the caller passes the
devices), the roofline terms (``roofline``: the H100's rates, op-by-op
flops and bytes counted under a dispatch mode, the NVLink collective
term) and the dry run over the production meshes (``dryrun``: every
--arch x shape id on meta tensors in bfloat16, per-device bytes, counted
terms, estimated collectives).

JAX's ``launch/hlo_analysis.py`` has no counterpart module, by design: it
parses XLA's post-partitioning HLO text, and the port compiles nothing,
so it has no HLO.  ``roofline.count`` takes its role.  It counts every
aten op as it executes, so an eager loop needs no trip-count correction
(``tests/test_torch_roofline.py::test_count_vs_hlo_aggregate`` holds it
against ``aggregate`` on one forward).  The one Python token loop too
long to count at full length, rwkv6's, is counted at shorter lengths and
extended (``dryrun.count_step``), the counterpart of ``aggregate``'s
``while``-loop multiplicity."""
