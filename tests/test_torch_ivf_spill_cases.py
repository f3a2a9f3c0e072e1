"""The reference's IVF spill cases (tests/test_ivf_spill.py) on the port:
rows spilled to their second cluster, no duplicate ids, the port's
BruteForceIndex as the oracle; every index on the CPU, the sharded one
on a mesh of eight `cpu` devices (the reference's default mesh is its
eight virtual host devices). Rewrite: the count of free slots the
reference reads through its `_free_slots()` is summed from the slot
free lists both packages keep (`_cluster_free`); the port has no such
method."""

from torch_reference_cases import port_cases

exec(port_cases("test_ivf_spill.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"co\._free_slots\(\)", "sum(len(f) for f in co._cluster_free)"),
    (r"ShardedIvfIndex\(DIM, nlist=",
     'ShardedIvfIndex(DIM, __import__("cortex_tpu_torch.parallel", '
     'fromlist=["build_mesh"]).build_mesh(8, devices=["cpu"] * 8), '
     'nlist='),
], cpu_calls=(r"\bTorchIvfIndex",)), globals())


def test_cases_run_on_the_port():
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
    assert IvfCorpus.__module__ == "cortex_tpu_torch.vector.ivf"  # noqa: F821
